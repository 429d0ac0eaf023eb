"""Reader and writer of the safetensors checkpoint format on the stdlib and
numpy, so the port needs no ``safetensors`` package.

A file is an 8-byte little-endian header length N, a JSON header of N
bytes (``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
and an optional ``"__metadata__"`` of string pairs), then the tensors' raw
little-endian bytes, the offsets counted from the end of the header.  The
format's own writer pads the header with spaces to a multiple of 8 bytes;
so does :func:`save_file`.

:func:`load_file` maps the file into memory and hands out each tensor as a
view of the map, so a 4.9 GB float32 RDT-1B file is not copied into Python
bytes; ``BF16`` (which numpy lacks) is read as ``uint16`` and viewed as
``torch.bfloat16``.  A header whose offsets overlap, leave a gap or run
past the file's end, or that names an unknown dtype, raises.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np
import torch

# safetensors dtype -> (numpy dtype the bytes are read as, torch dtype)
DTYPES = {
    "BOOL": (np.dtype(np.bool_), torch.bool),
    "U8": (np.dtype("u1"), torch.uint8),
    "I8": (np.dtype("i1"), torch.int8),
    "I16": (np.dtype("<i2"), torch.int16),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "F32": (np.dtype("<f4"), torch.float32),
    "F64": (np.dtype("<f8"), torch.float64),
}
_FROM_TORCH = {t: name for name, (_, t) in DTYPES.items()}
_FROM_NUMPY = {d: name for name, (d, _) in DTYPES.items() if name != "BF16"}
_MAX_HEADER = 100 * 1024 * 1024


def _parse(f, size: int):
    """(tensor entries in offset order, metadata, data start) of the open
    file ``f`` of ``size`` bytes, every entry checked."""
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{f.name}: {size} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", head)
    if n > min(_MAX_HEADER, size - 8):
        raise ValueError(f"{f.name}: header length {n} runs past the file's end ({size} bytes)")
    try:
        header = json.loads(f.read(n))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{f.name}: the header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{f.name}: the header is not a JSON object")
    meta = header.pop("__metadata__", None)
    if meta is not None and not (isinstance(meta, dict) and all(
            isinstance(k, str) and isinstance(v, str) for k, v in meta.items())):
        raise ValueError(f"{f.name}: __metadata__ must map strings to strings")
    entries = []
    for name, e in header.items():
        if not isinstance(e, dict) or set(e) != {"dtype", "shape", "data_offsets"}:
            raise ValueError(f"{f.name}: {name!r}: malformed entry {e!r}")
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{f.name}: {name!r}: unknown dtype {e['dtype']!r}")
        shape, off = e["shape"], e["data_offsets"]
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)
                and isinstance(off, list) and len(off) == 2
                and all(isinstance(o, int) for o in off)):
            raise ValueError(f"{f.name}: {name!r}: malformed shape or offsets {e!r}")
        nbytes = int(np.prod(shape, dtype=np.int64)) * DTYPES[e["dtype"]][0].itemsize
        if off[1] - off[0] != nbytes:
            raise ValueError(f"{f.name}: {name!r}: offsets {off} hold {off[1] - off[0]} bytes, "
                             f"its {e['dtype']} {shape} needs {nbytes}")
        entries.append((name, e["dtype"], tuple(shape), off[0], off[1]))
    entries.sort(key=lambda x: (x[3], x[4]))
    at = 0
    for name, _, _, begin, end in entries:
        if begin != at:
            what = "overlaps the tensor before it" if begin < at else "leaves a gap"
            raise ValueError(f"{f.name}: {name!r} at [{begin}, {end}) {what} (expected {at})")
        at = end
    start = 8 + n
    if start + at != size:
        what = "run past" if start + at > size else "stop short of"
        raise ValueError(f"{f.name}: the tensors' {at} bytes {what} the file's "
                         f"{size - start} data bytes")
    return entries, meta, start


def read_header(path: str) -> dict:
    """The header of ``path``, checked, without reading tensor data:
    ``{name: {"dtype", "shape", "data_offsets"}}``, plus ``"__metadata__"``
    when the file has one."""
    with open(path, "rb") as f:
        entries, meta, _ = _parse(f, os.fstat(f.fileno()).st_size)
    out = {name: {"dtype": dt, "shape": list(shape), "data_offsets": [b, e]}
           for name, dt, shape, b, e in entries}
    if meta is not None:
        out["__metadata__"] = meta
    return out


def load_file(path: str, device=None) -> dict:
    """{name: tensor} of ``path``.  Without ``device`` each tensor is a CPU
    view of a copy-on-write memory map of the file (writing to it leaves
    the file as it is); with one, each is copied there from the map, one at
    a time."""
    with open(path, "rb") as f:
        entries, _, start = _parse(f, os.fstat(f.fileno()).st_size)
    if not entries:
        return {}
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, dt, shape, begin, end in entries:
        np_dt = DTYPES[dt][0]
        raw = mm[start + begin:start + end]
        if (start + begin) % np_dt.itemsize:
            raw = raw.copy()          # an unaligned tensor: a file from another writer
        t = torch.from_numpy(raw.view(np_dt).reshape(shape))
        if dt == "BF16":
            t = t.view(torch.bfloat16)
        out[name] = t if device is None else t.to(device)
    return out


def _as_numpy(name: str, t):
    """(safetensors dtype, C-contiguous numpy array of the bytes) of a
    tensor or an array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype not in _FROM_TORCH:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
        dt = _FROM_TORCH[t.dtype]
        return dt, (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")       # (np.ascontiguousarray makes a 0-d array 1-d)
    key = a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype
    if key not in _FROM_NUMPY:
        raise ValueError(f"{name!r}: dtype {a.dtype} has no safetensors name")
    return _FROM_NUMPY[key], a.astype(DTYPES[_FROM_NUMPY[key]][0], copy=False)


def save_file(tensors: dict, path: str, metadata: Optional[dict] = None) -> int:
    """Write ``tensors`` ({name: torch tensor or numpy array}) to ``path``;
    returns the file's size in bytes.  Tensors are laid out with contiguous
    offsets, the wider dtypes first and each dtype's in sorted name order
    (the format's own writer's order, which keeps every tensor aligned to
    its item size), each written from its own buffer."""
    if metadata is not None and not all(isinstance(k, str) and isinstance(v, str)
                                        for k, v in metadata.items()):
        raise ValueError("metadata must map strings to strings")
    arrays = {name: _as_numpy(name, t) for name, t in tensors.items()}
    order = sorted(arrays, key=lambda k: (-DTYPES[arrays[k][0]][0].itemsize, k))
    header, at = {}, 0
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    for name in order:
        dt, a = arrays[name]
        header[name] = {"dtype": dt, "shape": list(a.shape),
                        "data_offsets": [at, at + a.nbytes]}
        at += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            a = arrays[name][1]
            if a.nbytes:
                f.write(memoryview(a.reshape(-1)).cast("B"))
    return 8 + len(blob) + at
