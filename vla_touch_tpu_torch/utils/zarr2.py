"""Zarr v2 arrays in a key-value store, as orbax writes them through
tensorstore (``use_zarr3`` false): ``<name>/.zarray`` (JSON) and one value
per chunk, ``<name>/<i>.<j>...`` (``0`` for a 0-d array), each chunk the C-
or F-order bytes of the chunk shape, zstd-compressed or raw.

The reader takes any mapping key bytes -> value bytes (an
:class:`utils.ocdbt.Database`); edge chunks are cropped, a missing chunk is
``fill_value``.  bfloat16 arrays come back as torch bfloat16 tensors (numpy
has none), the rest as numpy arrays.  The writer writes as orbax does: zstd
at level 1, C order, ``fill_value`` null, and one chunk per array up to
:data:`CHUNK_BYTES`; a larger array is cut along its first axis.

A *region* is the part of an array one process holds: per axis, the
``(start, stop)`` runs of positions it holds, ascending (one run
``(0, size)`` where the axis is whole; several where a fused projection
is split by heads; none where the process holds nothing).  Its values are
the runs concatenated on each axis.  :func:`read_region` reads only the
chunks a region overlaps; :func:`region_chunks` cuts a region's values
into chunks of a grid that the region's runs lie on.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Optional

import numpy as np
import torch

from vla_touch_tpu_torch.utils import zstd

ZSTD_LEVEL = 1
# One chunk per array up to this size (RDT-1B's largest leaf is 36 MB: its
# trees are one chunk per array).  `tools/torch_orbax_chunk_rate.py` times
# level-1 zstd per byte over chunk sizes; past a few MB the rate is flat, so
# larger chunks buy nothing but a coarser thread pool.
CHUNK_BYTES = 64 << 20

_DTYPES = {"bfloat16": np.dtype(np.uint16)}


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype of the stored bytes (bfloat16: its 16-bit patterns)."""
    return _DTYPES.get(name) or np.dtype(name)


def dtype_name(dtype) -> str:
    """The ``.zarray`` dtype of a numpy dtype or ``torch.bfloat16``."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return np.dtype(dtype).str


def _fill(meta: dict, dtype: np.dtype):
    v = meta.get("fill_value")
    if v is None:
        return None
    if isinstance(v, str):
        v = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[v]
    if meta["dtype"] == "bfloat16":
        bits = np.asarray(v, np.float32).view(np.uint32)
        # round to nearest even, as a float32 -> bfloat16 cast
        return np.uint16((int(bits) + 0x7FFF + ((int(bits) >> 16) & 1)) >> 16)
    return np.asarray(v).astype(dtype)


def chunk_key(name: str, index: tuple, sep: str = ".") -> bytes:
    return f"{name}/{sep.join(map(str, index)) if index else '0'}".encode()


def read_meta(store, name: str) -> dict:
    key = f"{name}/.zarray".encode()
    meta = json.loads(bytes(store[key]))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, not 2")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')} is not read")
    if meta.get("order", "C") not in ("C", "F"):
        raise ValueError(f"{name}: order {meta['order']}")
    return meta


def full_region(shape: tuple) -> tuple:
    return tuple(((0, int(n)),) for n in shape)


def region_shape(region: tuple) -> tuple:
    return tuple(sum(b - a for a, b in runs) for runs in region)


def take_region(arr, region: tuple):
    """The values of ``region`` of a whole numpy array or tensor."""
    for axis, runs in enumerate(region):
        if len(runs) == 1 and runs[0] == (0, arr.shape[axis]):
            continue
        parts = [arr[(slice(None),) * axis + (slice(a, b),)] for a, b in runs]
        if isinstance(arr, torch.Tensor):
            arr = torch.cat(parts, axis) if parts else arr.narrow(axis, 0, 0)
        else:
            arr = np.concatenate(parts, axis) if parts else arr[(slice(None),) * axis
                                                                 + (slice(0, 0),)]
    return arr


def _axis_pieces(runs, chunk: int) -> dict:
    """{chunk index: [(slice of the chunk, slice of the region's values)]}
    along one axis."""
    out, off = {}, 0
    for a, b in runs:
        i = a // chunk
        while i * chunk < b:
            lo, hi = max(a, i * chunk), min(b, (i + 1) * chunk)
            out.setdefault(i, []).append((slice(lo - i * chunk, hi - i * chunk),
                                          slice(off + lo - a, off + hi - a)))
            i += 1
        off += b - a
    return out


def read_array(store, name: str, where: Optional[str] = None):
    """The whole array ``name`` of ``store``.  ``where`` names the store in
    errors."""
    return read_region(store, name, None, where)[0]


def read_region(store, name: str, region: Optional[tuple], where: Optional[str] = None):
    """(values of ``region`` of the array ``name``, chunks read, chunks the
    region overlaps): only the chunks the region overlaps are read (a
    missing one is ``fill_value``).  ``region`` None: the whole array."""
    meta = read_meta(store, name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = storage_dtype(meta["dtype"])
    order, sep = meta.get("order", "C"), meta.get("dimension_separator", ".")
    compressed = meta.get("compressor") is not None
    whole = region is None or region == full_region(shape)
    region = full_region(shape) if region is None else tuple(map(tuple, region))
    if len(region) != len(shape):
        raise ValueError(f"{name}: a region of {len(region)} axes for shape {shape}")
    out = np.empty(region_shape(region), dtype.newbyteorder("="))
    fill = _fill(meta, dtype)
    nbytes = math.prod(chunks) * dtype.itemsize
    what = where or name
    # nothing to read where the region (or the array) is empty
    pieces = [_axis_pieces(runs, c) for runs, c in zip(region, chunks)] if out.size else [{}]
    n_read = n_overlapped = 0
    for index in itertools.product(*[sorted(p) for p in pieces]):
        n_overlapped += 1
        key = chunk_key(name, index, sep)
        parts = list(itertools.product(*[p[i] for p, i in zip(pieces, index)]))
        if key not in store:
            for part in parts:
                out[tuple(o for _, o in part)] = 0 if fill is None else fill
            continue
        raw = store[key]
        n_read += 1
        if whole and chunks == shape and order == "C" and dtype.isnative:
            # the chunk is the array: decompress straight into it
            dst = out.reshape(-1).view(np.uint8)
            if compressed:
                zstd.decompress(raw, reading=f"{what} {key.decode()}", into=dst)
            elif len(raw) == nbytes:
                dst[:] = np.frombuffer(raw, np.uint8)
            else:
                raise ValueError(f"{what} {key.decode()}: {len(raw)} bytes, {nbytes} expected")
            continue
        data = zstd.decompress(raw, reading=f"{what} {key.decode()}") if compressed else raw
        if len(data) != nbytes:
            raise ValueError(f"{what} {key.decode()}: {len(data)} bytes, {nbytes} expected")
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        for part in parts:
            out[tuple(o for _, o in part)] = chunk[tuple(c for c, _ in part)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16), n_read, n_overlapped
    return out, n_read, n_overlapped


def host_array(value) -> tuple:
    """(C-contiguous numpy array of the stored bytes, zarr dtype name) of a
    numpy array, number or tensor (bfloat16: its bits as uint16)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return t.contiguous().cpu().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.contiguous().cpu().numpy()
    else:
        arr = np.asarray(value)
        arr = arr if arr.flags.c_contiguous else arr.copy(order="C")
    if arr.dtype.hasobject:
        raise TypeError(f"cannot write an array of {arr.dtype}")
    arr = arr.astype(arr.dtype.newbyteorder("<")) if arr.dtype.byteorder == ">" else arr
    return arr, dtype_name(arr.dtype)


def chunk_shape(shape: tuple, itemsize: int) -> tuple:
    """One chunk up to :data:`CHUNK_BYTES`; beyond, rows of the first axis."""
    if not shape:
        return ()
    if 0 in shape:
        return tuple(max(1, s) for s in shape)
    rows = max(1, CHUNK_BYTES // (math.prod(shape[1:]) * itemsize))
    return (min(shape[0], rows),) + tuple(shape[1:])


def zarray(shape: tuple, chunks: tuple, dtype: str) -> bytes:
    """The ``.zarray`` JSON as tensorstore writes it (keys sorted, compact)."""
    meta = {"chunks": list(chunks),
            "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def array_chunks(name: str, arr: np.ndarray, chunks: tuple):
    """[(key, memoryview of the raw chunk)] of a C-contiguous array cut as
    ``chunks`` (only the first axis is cut): every chunk, zeros included."""
    if not arr.shape:
        return [(chunk_key(name, ()), memoryview(arr.reshape(1)).cast("B"))]
    if arr.size == 0:
        return []
    n = chunks[0]
    rest = (0,) * (arr.ndim - 1)
    out = []
    for i in range(max(1, -(-arr.shape[0] // n))):
        part = arr[i * n:(i + 1) * n]
        if part.shape[0] < n:
            # an edge chunk is stored at the full chunk shape
            full = np.zeros((n,) + arr.shape[1:], arr.dtype)
            full[:part.shape[0]] = part
            part = full
        out.append((chunk_key(name, (i,) + rest), memoryview(part.reshape(-1)).cast("B")))
    return out


def region_chunk_indices(region: tuple, chunks: tuple, shape: tuple) -> list:
    """The chunk indices of the grid ``chunks`` that ``region`` holds
    whole: each run starts on the grid and ends on it or at the array's
    edge (else ValueError)."""
    axes = []
    for runs, c, n in zip(region, chunks, shape):
        idx = []
        for a, b in runs:
            if a % c or (b % c and b != n):
                raise ValueError(f"run ({a}, {b}) of an axis of {n} is off the grid of "
                                 f"chunk {c}")
            idx += range(a // c, -(-b // c))
        axes.append(idx)
    return list(itertools.product(*axes))


def region_chunks(name: str, values: np.ndarray, region: tuple, chunks: tuple,
                  indices) -> list:
    """[(key, memoryview of the raw chunk)] of the chunks ``indices`` of a
    region's C-contiguous ``values`` (:func:`region_chunk_indices` names
    the chunks it holds); an edge chunk is stored at the full chunk
    shape, zero past the edge."""
    if not values.shape:
        return [(chunk_key(name, ()), memoryview(values.reshape(1)).cast("B"))]
    pieces = [_axis_pieces(runs, c) for runs, c in zip(region, chunks)]
    out = []
    for index in indices:
        # each chunk lies within one run of every axis: one piece
        part = tuple(p[i][0][1] for p, i in zip(pieces, index))
        block = values[part]
        if block.shape != tuple(chunks):
            full = np.zeros(chunks, values.dtype)
            full[tuple(slice(0, n) for n in block.shape)] = block
            block = full
        block = np.ascontiguousarray(block)
        out.append((chunk_key(name, tuple(index)), memoryview(block.reshape(-1)).cast("B")))
    return out


def encode_chunk(raw) -> bytes:
    return zstd.compress(raw, ZSTD_LEVEL)
