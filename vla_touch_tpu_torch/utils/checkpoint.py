"""Directory checkpoints of parameter trees + JSON metadata (counterpart of
``vla_touch_tpu/utils/checkpoint.py``, its msgpack half).

A tree file is flax's msgpack state-dict format, byte for byte as
``flax.serialization.to_bytes`` writes a tree of numpy leaves that
``jax.tree.map`` rebuilt (every dict's keys sorted): nested string-keyed
maps whose leaves are msgpack ext type 1, each holding the msgpack array
``(shape, dtype name, C-order bytes)``.  A numpy scalar is ext type 3 with
the same payload.  The codec below is written on the standard library and
numpy.  A bfloat16 leaf (a torch tensor; numpy has no bfloat16) is the
payload ``(shape, "bfloat16", bytes)`` as flax writes ml_dtypes' bfloat16,
and is read back as a torch bfloat16 tensor.  flax chunks an array over
2^30 bytes into a ``__msgpack_chunked_array__`` map; the port's leaves are
far smaller (RDT-1B's largest is 36 MB), so the reader raises on one.  A
tree is written to its file as it is encoded, leaf by leaf, and read
through a memory map, so a multi-GB tree (RDT-1B's optimizer state) is
never held twice in host memory.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import re
import shutil
import struct
from typing import Any, Optional

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30


# ---- msgpack (the subset flax's state dicts use) ------------------------------


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 128:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _pack_len(n: int, small: int, small_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form below ``small_max``, else the 8/16/32-bit
    forms (``codes``; ``None`` where the type has no 8-bit form)."""
    if n < small_max:
        out.append(bytes([small | n]))
        return
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(n)


def _ext_header(code: int, n: int) -> bytes:
    """The header of an ext object of ``n`` payload bytes."""
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    if n < 1 << 8:
        return bytes([0xC7, n, code])
    if n < 1 << 16:
        return b"\xc8" + struct.pack(">H", n) + bytes([code])
    return b"\xc9" + struct.pack(">I", n) + bytes([code])


class _BF16:
    """A bfloat16 leaf on its way to the file: its 16-bit patterns."""

    def __init__(self, t: torch.Tensor):
        self.bits = t.detach().contiguous().cpu().view(torch.int16).numpy()


def _pack_array(code: int, arr: np.ndarray, out: list, name: str = None) -> None:
    """Ext ``code`` holding the msgpack of (shape, dtype name, C-order
    bytes), as flax's ``_ndarray_to_bytes``; the data goes to ``out`` as a
    view of the array, not a copy."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    head: list = [b"\x93"]
    _pack(tuple(int(d) for d in arr.shape), head)
    _pack(name or arr.dtype.name, head)
    _pack_len(arr.nbytes, 0, 0, (0xC4, 0xC5, 0xC6), head)
    head = b"".join(head)
    out.append(_ext_header(code, len(head) + arr.nbytes))
    out.append(head)
    out.append(memoryview(arr.reshape(-1)).cast("B"))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, _BF16)):
        arr, name = (obj.bits, "bfloat16") if isinstance(obj, _BF16) else (obj, None)
        if arr.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"array of {arr.nbytes} bytes: chunked leaves are not written")
        _pack_array(EXT_NDARRAY, arr, out, name)
    elif isinstance(obj, np.generic):
        _pack_array(EXT_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), 0, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    """``raw_bin``: bin objects come back as views of the data, not copies
    (an array payload's buffer, copied once into its array)."""

    def __init__(self, data: bytes, raw_bin: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_bin = raw_bin

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self.num("B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sized:
            b = self.take(self.num(sized[c]))
            return b if self.raw_bin else bytes(b)
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in ext:
            n = self.num(ext[c])
            return self.ext(self.num("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(self.num("b"), fixext[c])
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.num(scalars[c])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return str(self.take(self.num(strs[c])), "utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(self.num(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map(self.num(">H" if c == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, buf = _Reader(self.take(n), raw_bin=True).read()
        if name == "bfloat16":
            bits = np.frombuffer(buf, dtype=np.int16).reshape(shape).copy()
            return torch.from_numpy(bits).view(torch.bfloat16)
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    r = _Reader(data)
    out = r.read()
    trailing = r.pos != len(r.data)
    r.data.release()
    if trailing:
        raise ValueError("trailing bytes after the msgpack object")
    return out


# ---- trees -------------------------------------------------------------------


def _numpy_tree(tree):
    """Every leaf as a numpy array, every dict's keys sorted (as
    ``jax.tree.map`` rebuilds a tree before flax serializes it)."""
    if isinstance(tree, dict):
        return {str(k): _numpy_tree(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _numpy_tree(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return _BF16(tree)
        # made contiguous where it lies (a transposed view on the card), then
        # one copy to the host
        return tree.detach().contiguous().cpu().numpy()
    return np.asarray(tree)


def _check_chunked(tree, path=()):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError(f"{'/'.join(path)}: chunked array leaves (over 2^30 bytes) "
                             f"are not read")
        for k, v in tree.items():
            _check_chunked(v, path + (k,))


def _match(tree, target, path=()):
    """``tree`` restricted to ``target``'s structure, as flax's
    ``from_state_dict``: every key of ``target`` must be there; leaves must
    agree in shape."""
    if not isinstance(target, dict):
        t_shape, shape = (tuple(t.shape) if isinstance(t, torch.Tensor) else np.shape(t)
                          for t in (target, tree))
        if shape != t_shape:
            raise ValueError(f"{'/'.join(path)}: shape {shape} != {t_shape}")
        return tree
    if not isinstance(tree, dict):
        raise ValueError(f"{'/'.join(path)}: a leaf where the target has a subtree")
    missing = sorted(set(map(str, target)) - set(tree))
    if missing:
        raise ValueError(f"{'/'.join(path) or '/'}: keys {missing[:8]} missing from the file")
    return {k: _match(tree[str(k)], v, path + (str(k),)) for k, v in target.items()}


class _FileOut:
    """``_pack``'s output list, written straight to a file."""

    def __init__(self, f):
        self.append = f.write


def save_pytree(path: str, tree: Any) -> int:
    """Write ``tree`` (numpy arrays, tensors, numbers; dicts, lists) as
    flax's bytes; returns the file's size."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _pack(_numpy_tree(tree), _FileOut(f))
        return f.tell()


def load_pytree(path: str, target: Any = None) -> Any:
    """The file's tree of numpy arrays (bfloat16 leaves: torch tensors);
    with ``target``, restricted to its structure (keys and shapes
    validated)."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        tree = unpackb(m)
    _check_chunked(tree)
    return tree if target is None else _match(tree, target)


def save_json(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=default)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_stats(path: str, stats: dict) -> None:
    save_json(path, {k: np.asarray(v).tolist() for k, v in stats.items()})


def load_stats(path: str) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in load_json(path).items()}


# ---- step-numbered checkpoint directories -------------------------------------

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def list_checkpoints(root: str) -> list:
    """Sorted (step, path) pairs of ``checkpoint-<n>`` dirs under root."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def latest_checkpoint(root: str) -> Optional[str]:
    cks = list_checkpoints(root)
    return cks[-1][1] if cks else None


def prune_checkpoints(root: str, total_limit: int) -> None:
    """Delete the oldest ``checkpoint-*`` dirs beyond ``total_limit``."""
    cks = list_checkpoints(root)
    for _, path in cks[: max(0, len(cks) - total_limit)]:
        shutil.rmtree(path, ignore_errors=True)
