"""K2: the fused UNet-1D conditional residual block — the wrapper of
``csrc/resblock.cu`` (counterpart of ``vla_touch_tpu/ops/pallas_unet.py``).

A block's weights come as one dict of tensors with a leading stacked-network
axis S (the v and s nets of the stochastic interpolant), in kernel layout::

    w0 (S, k, Cin, C)  b0 (S, C)   g0w/g0b (S, C)      conv0 + GroupNorm0
    fw (S, G, 2C)      fb (S, 2C)                       FiLM (scale | bias)
    w1 (S, k, C, C)    b1 (S, C)   g1w/g1b (S, C)      conv1 + GroupNorm1
    wr (S, Cin, C)     br (S, C)                        1x1 residual (Cin != C)

:func:`resblock_fused` launches the kernel on CUDA tensors and computes
:func:`resblock_ref` on CPU tensors; ``resblock_fused.launches`` counts
calls that launched the kernel (one cooperative launch each, under
:func:`k2_plan`).  Any time axis (the kernel walks it in chunks of 64
steps); a block too wide for one SM's shared memory as it is takes splits
of at most 256 input channels, and then, if it must, its norm items stream
a group's values from L2 (``csrc/resblock.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_P = ctypes.c_void_p
_I = ctypes.c_int

# K2's plan: the kernel's products (conv0, FiLM, the 1x1 residual; then
# conv1) are cut into items of K2_COLS output columns x one range of their
# 16-row mma steps; at least K2_MIN_STEPS steps an item
K2_COLS = 64
K2_STEP = 16
K2_MIN_STEPS = 4


def mish(x):
    return x * torch.tanh(F.softplus(x))


def conv1d_taps(x, w, b, stride: int = 1, padding: int = 0):
    """Stacked 1-D conv as one tap-stacked matmul per network.
    x (S, B, T, Ci), w (S, k, Ci, F), b (S, F) -> (S, B, T_out, F)."""
    S, B, T, Ci = x.shape
    k, Fo = w.shape[1], w.shape[3]
    xp = F.pad(x, (0, 0, padding, padding))
    T_out = (T + 2 * padding - k) // stride + 1
    taps = torch.cat([xp[:, :, d: d + (T_out - 1) * stride + 1: stride]
                      for d in range(k)], dim=-1)
    y = torch.bmm(taps.reshape(S, B * T_out, k * Ci), w.reshape(S, k * Ci, Fo))
    return y.reshape(S, B, T_out, Fo) + b[:, None, None, :]


def group_norm(y, weight, bias, n_groups: int, eps: float):
    """torch GroupNorm over channels-last (S, B, T, C): each group is
    normalised over (T, C/G) jointly, biased variance."""
    S, B, T, C = y.shape
    yg = y.reshape(S, B, T, n_groups, C // n_groups)
    mean = yg.mean(dim=(2, 4), keepdim=True)
    var = yg.var(dim=(2, 4), keepdim=True, unbiased=False)
    yn = ((yg - mean) * torch.rsqrt(var + eps)).reshape(S, B, T, C)
    return yn * weight[:, None, None, :] + bias[:, None, None, :]


def resblock_ref(x, cond, p: dict, *, n_groups: int = 8, eps: float = 1e-5):
    """Plain version: the block's math in float32.  x (S, B, T, Cin), cond
    (S, B, G) -> (S, B, T, C) float32."""
    f = {name: t.float() for name, t in p.items()}
    x, cond = x.float(), cond.float()
    k = f["w0"].shape[1]
    C = f["w0"].shape[-1]
    h = conv1d_taps(x, f["w0"], f["b0"], padding=k // 2)
    h = mish(group_norm(h, f["g0w"], f["g0b"], n_groups, eps))
    film = torch.bmm(mish(cond), f["fw"]) + f["fb"][:, None, :]
    h = film[:, :, None, :C] * h + film[:, :, None, C:]
    h = conv1d_taps(h, f["w1"], f["b1"], padding=k // 2)
    h = mish(group_norm(h, f["g1w"], f["g1b"], n_groups, eps))
    if "wr" in f:
        res = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), f["wr"])
        res = res.reshape(h.shape) + f["br"][:, None, None, :]
    else:
        res = x
    return h + res


def k2_steps(Cin: int, C: int, G: int, k: int, has_res: bool) -> dict:
    """(mma steps, column tiles) of each product of one block: a step is 16
    input channels of one tap."""
    ch = lambda n: -(-n // K2_STEP)                          # noqa: E731
    tiles = lambda n: -(-n // K2_COLS)                       # noqa: E731
    out = {"conv0": (k * ch(Cin), tiles(C)), "film": (ch(G), tiles(2 * C)),
           "conv1": (k * ch(C), tiles(C))}
    if has_res:
        out["res"] = (ch(Cin), tiles(C))
    return out


def k2_split_steps(steps: int, splits: int, z: int) -> tuple:
    """[first, end) mma steps of split ``z``: the splits differ by at most
    one step (the kernel's ``split_step``)."""
    return z * steps // splits, (z + 1) * steps // splits


def _phase_splits(jobs: dict, S: int, n_ctas: int) -> dict:
    """Splits per product of one phase: items of about equal weight rows
    (at least K2_MIN_STEPS steps), as few steps an item as keeps the items
    (S x column tiles x splits) within the grid's ``n_ctas`` blocks."""
    work = S * sum(steps * tiles for steps, tiles in jobs.values())
    target = max(K2_MIN_STEPS, -(-work // max(1, n_ctas)))
    while True:
        splits = {j: min(steps, -(-steps // target)) for j, (steps, _) in jobs.items()}
        items = S * sum(tiles * splits[j] for j, (_, tiles) in jobs.items())
        if items <= n_ctas or all(v == 1 for v in splits.values()):
            return splits
        target += 1


def k2_split_chunks(chunks: int, taps: int, splits: int) -> int:
    """The most 16-channel chunks of input one of ``splits`` splits of a
    product of ``taps`` taps over ``chunks`` chunks spans (the kernel's
    ``split_chunks``)."""
    steps = taps * chunks
    return max((e - 1) // taps + 1 - b // taps
               for b, e in (k2_split_steps(steps, splits, z) for z in range(splits)))


def k2_plan(Cin: int, C: int, G: int, k: int, S: int, n_ctas: int, has_res: bool,
            max_chunks: int = 0) -> dict:
    """Splits of conv0, FiLM, the residual (when ``has_res``) and conv1 for
    a grid of ``n_ctas`` blocks: phase 1 (conv0, FiLM, residual) and phase
    3 (conv1) each fill the grid with items of about equal weight bytes.
    ``max_chunks`` > 0 (a block too wide for one SM as it is): every
    product's splits span at most that many 16-channel chunks of input, the
    width of the kernel's staged input."""
    steps = k2_steps(Cin, C, G, k, has_res)
    plan = _phase_splits({j: v for j, v in steps.items() if j != "conv1"}, S, n_ctas)
    plan.update(_phase_splits({"conv1": steps["conv1"]}, S, n_ctas))
    if max_chunks:
        ch = lambda n: -(-n // K2_STEP)                      # noqa: E731
        for job, chunks, taps in (("conv0", ch(Cin), k), ("film", ch(G), 1),
                                  ("res", ch(Cin), 1), ("conv1", ch(C), k)):
            if job in plan:
                while k2_split_chunks(chunks, taps, plan[job]) > max_chunks:
                    plan[job] += 1
    return plan


def k2_scratch_bytes(S: int, B: int, T: int, C: int, plan: dict) -> int:
    """Bytes of the kernel's one scratch buffer: the float32 partials of
    each product's splits, then conv1's bf16 operand."""
    tc = S * B * T * C
    return 4 * (tc * (plan["conv0"] + plan.get("res", 0) + plan["conv1"])
                + S * B * 2 * C * plan["film"]) + 2 * tc


def _lib():
    from vla_touch_tpu_torch.csrc import build

    lib = build.library("resblock")
    if lib.resblock_bf16.argtypes is None:
        lib.resblock_bf16.argtypes = [_P] * 15 + [ctypes.c_longlong, _P] + [_I] * 8 \
            + [ctypes.c_float] + [_I] * 4 + [_P]
        lib.resblock_bf16.restype = _I
        lib.resblock_ctas.argtypes = [_I] * 6 + [ctypes.POINTER(_I)] * 2
        lib.resblock_ctas.restype = _I
    return lib


@functools.cache
def _ctas(device_index: int, T: int, Cin: int, C: int, G: int, k: int,
          n_groups: int) -> tuple:
    """(blocks of one cooperative launch of the kernel at this shape, the
    16-channel chunks of input a split may span: 0 for any)."""
    from vla_touch_tpu_torch.csrc import build

    lib = _lib()
    n, wcap = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(lib, lib.resblock_ctas(T, Cin, C, G, k, n_groups, ctypes.byref(n),
                                           ctypes.byref(wcap)), "resblock_fused")
    return n.value, wcap.value


def _check(name, t, shape, device):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"resblock_fused: {name} must be bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"resblock_fused: {name} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"resblock_fused: {name} must be contiguous on {device}")


def resblock_fused(x, cond, p: dict, *, n_groups: int = 8, eps: float = 1e-5):
    """Fused conditional residual block over S stacked networks.

    x (S, B, T, Cin), cond (S, B, G), ``p`` in the module's kernel layout
    -> (S, B, T, C) in x's dtype.  CUDA: everything bf16 and contiguous,
    C a multiple of 16 and of ``n_groups``, an odd kernel size; anything
    else raises.
    """
    if x.device.type == "cpu":
        return resblock_ref(x, cond, p, n_groups=n_groups, eps=eps).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_fused: unsupported device {x.device}")
    from vla_touch_tpu_torch.csrc import build

    build.refuse_grad("resblock_fused", None, x, cond, *p.values())
    S, B, T, Cin = x.shape
    k, C = p["w0"].shape[1], p["w0"].shape[-1]
    G = cond.shape[-1]
    if C % 16 or C % n_groups or k % 2 == 0:
        raise ValueError(f"resblock_fused: unsupported T={T}, C={C}, k={k}, "
                         f"groups={n_groups}")
    dev = x.device
    _check("x", x, (S, B, T, Cin), dev)
    _check("cond", cond, (S, B, G), dev)
    shapes = {"w0": (S, k, Cin, C), "b0": (S, C), "g0w": (S, C), "g0b": (S, C),
              "fw": (S, G, 2 * C), "fb": (S, 2 * C), "w1": (S, k, C, C),
              "b1": (S, C), "g1w": (S, C), "g1b": (S, C)}
    has_res = "wr" in p
    if has_res:
        shapes.update(wr=(S, Cin, C), br=(S, C))
    elif Cin != C:
        raise ValueError("resblock_fused: Cin != C needs the residual conv")
    for name, shape in shapes.items():
        _check(name, p[name], shape, dev)
        if p[name].data_ptr() % 16:
            raise ValueError(f"resblock_fused: {name} must be 16-byte aligned")
    ctas, wcap = _ctas(dev.index if dev.index is not None else torch.cuda.current_device(),
                       T, Cin, C, G, k, n_groups)
    if ctas < 1:
        raise RuntimeError(f"resblock_fused: one block of T={T}, Cin={Cin}, C={C}, G={G}, "
                           f"k={k} does not fit an SM: no cooperative launch is possible")
    plan = k2_plan(Cin, C, G, k, S, ctas, has_res, wcap)
    nbytes = k2_scratch_bytes(S, B, T, C, plan)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    out = torch.empty((S, B, T, C), dtype=torch.bfloat16, device=dev)
    wr = p["wr"].data_ptr() if has_res else None
    br = p["br"].data_ptr() if has_res else None
    lib = _lib()
    err = lib.resblock_bf16(
        x.data_ptr(), cond.data_ptr(), p["w0"].data_ptr(), p["b0"].data_ptr(),
        p["g0w"].data_ptr(), p["g0b"].data_ptr(), p["fw"].data_ptr(),
        p["fb"].data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
        p["g1w"].data_ptr(), p["g1b"].data_ptr(), wr, br, scratch.data_ptr(), nbytes,
        out.data_ptr(), S, B, T, Cin, C, G, k, n_groups, float(eps),
        plan["conv0"], plan["film"], plan.get("res", 1), plan["conv1"],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "resblock_fused")
    resblock_fused.launches += 1
    return out


resblock_fused.launches = 0
