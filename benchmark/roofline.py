"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM and
the operations and bytes the benchmark's work needs, counted from shapes.

Peaks are NVIDIA's data sheet (dense, no sparsity) at the full 700 W limit.
Operations count 2 per multiply-add; attention 4 B H Lq Lkv D (q.k^T and
p.v).  A count takes the work the inputs need: the real language tokens of
each row (not the padding to 1024), the real rows of a batch (not the
bucket's spare rows), the head dim the model has (SigLIP's 72, though K1
pads it to 80).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # HBM3, bytes/s
BF16_FLOPS = 989e12                # dense bf16 tensor cores, FLOP/s


def k1_bound_s(B, Lq, Lkv, H, D, masked) -> tuple:
    """(bytes s, operations s) of one K1 call: q, k, v and the mask read
    once, the output written once (bf16); the two products at the bf16
    peak."""
    nbytes = 2 * (2 * B * Lq * H * D + 2 * B * Lkv * H * D) + (B * Lkv if masked else 0)
    flops = 4.0 * B * H * Lq * Lkv * D
    return nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS


def least_s(bounds) -> tuple:
    """Sum of each call's least time (the larger of its two bounds) and
    which bound binds most of that time: ('bytes' | 'operations')."""
    total, by_bytes = 0.0, 0.0
    for b, f in bounds:
        total += max(b, f)
        by_bytes += b if b >= f else 0.0
    return total, ("bytes" if by_bytes > total / 2 else "operations")


def siglip_k1_calls(vcfg: dict, frames: int) -> list:
    """K1 calls of one encode of ``frames`` frames: one per layer."""
    n = (vcfg["image_size"] // vcfg["patch_size"]) ** 2
    D = vcfg["hidden_size"] // vcfg["num_heads"]
    return [k1_bound_s(frames, n, n, vcfg["num_heads"], D, False)] * vcfg["num_layers"]


def rdt_k1_calls(cfg: dict, lang_lens, passes: int) -> list:
    """K1 calls of ``passes`` forward passes of RDT over rows whose real
    language lengths are ``lang_lens``: per block a self-attention over
    horizon + 3 tokens and a cross-attention (even blocks: the row's
    language, masked; odd blocks: the image condition).  Counted per row,
    so each row's own length enters."""
    H, x = cfg["num_heads"], cfg["horizon"] + 3
    D = cfg["hidden_size"] // H
    B = len(lang_lens)
    out = []
    for _ in range(passes):
        for i in range(cfg["depth"]):
            out.append(k1_bound_s(B, x, x, H, D, False))
            if i % 2 == 0:
                out.extend(k1_bound_s(1, x, L, H, D, True) for L in lang_lens)
            else:
                out.append(k1_bound_s(B, x, cfg["img_cond_len"], H, D, False))
    return out


def _lin(rows, k, n) -> float:
    return 2.0 * rows * k * n


def _adaptor_depth(kind: str) -> int:
    return 1 if kind == "linear" else int(kind[len("mlp"):kind.index("x_gelu")])


def _adaptor(rows, n_in, H, kind) -> float:
    d = _adaptor_depth(kind)
    return _lin(rows, n_in, H) + (d - 1) * _lin(rows, H, H)


def rdt_block_flops(cfg: dict, x: int, L: int, with_kv: bool) -> float:
    """One block's forward over ``x`` query tokens with a condition of
    ``L`` tokens (its K/V projection counted when ``with_kv``)."""
    H = cfg["hidden_size"]
    f = (_lin(x, H, 3 * H) + 4.0 * x * x * H + _lin(x, H, H)         # self-attention
         + _lin(x, H, H) + 4.0 * x * L * H + _lin(x, H, H)           # cross: q, attend, proj
         + 2 * _lin(x, H, H))                                         # MLP of the hidden width
    return f + (_lin(L, H, 2 * H) if with_kv else 0.0)


def rdt_forward_flops(cfg: dict, lang_len: int, with_kv: bool = True) -> float:
    """RDT's forward for one row: the timestep and frequency embedders,
    the blocks, the final layer (adaptors not included)."""
    H, x = cfg["hidden_size"], cfg["horizon"] + 3
    f = 2 * (_lin(1, 256, H) + _lin(1, H, H))
    for i in range(cfg["depth"]):
        L = lang_len if i % 2 == 0 else cfg["img_cond_len"]
        f += rdt_block_flops(cfg, x, L, with_kv)
    return f + _lin(x, H, H) + _lin(x, H, cfg["output_dim"])


def condition_flops(cfg: dict, lang_len: int) -> float:
    """The language and image adaptors and every block's condition K/V
    projection, for one row."""
    H = cfg["hidden_size"]
    f = (_adaptor(lang_len, cfg["lang_token_dim"], H, cfg["lang_adaptor"])
         + _adaptor(cfg["img_cond_len"], cfg["img_token_dim"], H, cfg["img_adaptor"]))
    for i in range(cfg["depth"]):
        f += _lin(lang_len if i % 2 == 0 else cfg["img_cond_len"], H, 2 * H)
    return f


def siglip_flops(vcfg: dict, frames: int) -> float:
    """SigLIP's forward over ``frames`` frames: the patch product and the
    layers (attention at the model's head dim)."""
    D, n = vcfg["hidden_size"], (vcfg["image_size"] // vcfg["patch_size"]) ** 2
    per = _lin(n, vcfg["patch_size"] ** 2 * vcfg["num_channels"], D) + vcfg["num_layers"] * (
        _lin(n, D, 3 * D) + 4.0 * n * n * D + _lin(n, D, D) + 2 * _lin(n, D, vcfg["mlp_dim"]))
    return frames * per


def served_chunk_flops(config: dict, lang_len: int) -> float:
    """One served chunk: SigLIP over the request's frames, the conditions
    projected once, then per solver step the state adaptor over the
    horizon and RDT's forward over horizon + 3 rows without the condition
    K/V (cached); the state adaptor once for the state token."""
    cfg, vcfg, pol = config["rdt"], config["vision"], config["policy"]
    H = cfg["hidden_size"]
    steps = config["noise"]["num_inference_timesteps"]
    frames = pol["img_history_size"] * pol["num_cameras"]
    state_in = 2 * cfg["state_token_dim"]
    f = siglip_flops(vcfg, frames) + condition_flops(cfg, lang_len)
    f += _adaptor(1, state_in, H, cfg["state_adaptor"])
    f += steps * (_adaptor(cfg["horizon"], state_in, H, cfg["state_adaptor"])
                  + rdt_forward_flops(cfg, lang_len, with_kv=False))
    return f


def train_step_flops(config: dict, lang_lens, frames: int) -> dict:
    """One optimizer step over rows with real language lengths
    ``lang_lens``: RDT's forward with its adaptors times 3 (a backward of
    twice the forward's work) per row, and the frozen SigLIP's forward
    over ``frames`` frames.  FLOP, by part."""
    cfg = config["rdt"]
    H, state_in = cfg["hidden_size"], 2 * cfg["state_token_dim"]
    rdt = 0.0
    for L in lang_lens:
        rdt += 3 * (rdt_forward_flops(cfg, L)
                    + _adaptor(L, cfg["lang_token_dim"], H, cfg["lang_adaptor"])
                    + _adaptor(cfg["img_cond_len"], cfg["img_token_dim"], H, cfg["img_adaptor"])
                    + _adaptor(cfg["horizon"] + 1, state_in, H, cfg["state_adaptor"]))
    return {"rdt": rdt, "siglip": siglip_flops(config["vision"], frames)}
