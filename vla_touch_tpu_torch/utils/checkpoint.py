"""Directory checkpoints of parameter trees + JSON metadata (counterpart of
``vla_touch_tpu/utils/checkpoint.py``): flax msgpack files, and orbax
directories (below, ``save_pytree_orbax``).

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

import base64
import collections
import dataclasses
import itertools
import json
import mmap
import os
import re
import shutil
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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


# ---- orbax directories ---------------------------------------------------------
#
# What orbax's StandardCheckpointer writes (use_ocdbt, zarr v2): ``_METADATA``
# (JSON: each leaf's key path and value type), ``_CHECKPOINT_METADATA`` and
# one OCDBT database (utils/ocdbt.py) holding each array as zarr v2
# (utils/zarr2.py) under the name of its key path joined by ".".
#
# A process group of world > 1 writes as JAX's processes do: each rank its
# own database ``ocdbt.process_<rank>/`` holding the chunks of its shards
# (a leaf given as a :class:`Shard`; a chunk is a shard, and a chunk that
# several ranks hold is written by the lowest of them, as orbax writes
# replica 0) and ``array_metadatas/process_<rank>``; rank 0 also the
# arrays' ``.zarray``, ``_sharding`` and the two metadata files and, once
# every rank has written, the root database that joins the ranks'
# (``ocdbt.join``).  The reader follows the root's references, and with a
# region per leaf reads only the chunks each region overlaps.

ORBAX_METADATA = "_METADATA"
ORBAX_CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ORBAX_SHARDING = "_sharding"
ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                 "StandardCheckpointHandler")
KEY_SEQUENCE, KEY_DICT = 1, 2
_ARRAY_TYPES = ("jax.Array", "np.ndarray")
# an empty container's value type
_EMPTY_TYPES = {dict: "Dict", list: "List", tuple: "Tuple"}


@dataclasses.dataclass
class Shard:
    """One rank's part of an array leaf of a tree that several ranks write
    (:func:`save_pytree_orbax` at world > 1): the array's global ``shape``,
    the rank's ``region`` of it (``utils/zarr2.py``: per axis, the (start,
    stop) runs of positions it holds) and ``local``, the region's values
    (a tensor or numpy array).  ``spec``: the mesh axis each array axis is
    split over (a JAX PartitionSpec as a tuple; ``()``: replicated),
    recorded in ``_sharding``."""

    shape: tuple
    region: tuple
    local: Any
    spec: tuple = ()


def _io_threads() -> int:
    return max(1, min(16, os.cpu_count() or 1))


def _bounded_map(pool, fn, items, window: int):
    """``pool.map`` in order with at most ``window`` results in flight."""
    it = iter(items)
    pending = collections.deque(pool.submit(fn, x) for x in itertools.islice(it, window))
    while pending:
        done = pending.popleft().result()
        pending.extend(pool.submit(fn, x) for x in itertools.islice(it, 1))
        yield done


def _orbax_leaves(tree, keys=()):
    """[(((key, key_type), ...), leaf)] of a nested dict / list / tuple tree;
    an empty container is a leaf of its own (orbax records it)."""
    if isinstance(tree, dict) and tree:
        return [x for k, v in tree.items() for x in _orbax_leaves(v, keys + ((str(k), KEY_DICT),))]
    if isinstance(tree, (list, tuple)) and tree:
        return [x for i, v in enumerate(tree)
                for x in _orbax_leaves(v, keys + ((str(i), KEY_SEQUENCE),))]
    return [(keys, tree)]


def _orbax_entries(tree) -> tuple:
    """(the ``_METADATA`` tree, [(array name, its entry's value metadata,
    leaf)]) of a tree; the arrays' ``write_shape`` is for the caller."""
    tree_meta, arrays = {}, []
    for keys, leaf in _orbax_leaves(tree):
        if not keys:
            raise ValueError("the tree must be a dict, list or tuple")
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
        if leaf is None or (isinstance(leaf, (dict, list, tuple)) and not leaf):
            kind = "None" if leaf is None else next(
                v for t, v in _EMPTY_TYPES.items() if isinstance(leaf, t))
            entry["value_metadata"] = {"value_type": kind, "skip_deserialize": True}
        else:
            entry["value_metadata"] = {"value_type": "jax.Array", "skip_deserialize": False}
            arrays.append((".".join(k for k, _ in keys), entry["value_metadata"], leaf))
        tree_meta[str(tuple(k for k, _ in keys))] = entry
    return tree_meta, arrays


def _write_json(path: str, obj, **kw) -> int:
    data = json.dumps(obj, **kw).encode()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def _write_orbax_metadata(root: str, tree_meta: dict, t0: int) -> int:
    """``_METADATA`` and ``_CHECKPOINT_METADATA`` (committed now)."""
    return (_write_json(os.path.join(root, ORBAX_METADATA), {
                "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
            + _write_json(os.path.join(root, ORBAX_CHECKPOINT_METADATA), {
                "item_handlers": ORBAX_HANDLER, "metrics": {}, "performance_metrics": {},
                "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                "custom_metadata": {}}))


def _put_chunks(writer, chunks) -> None:
    """Compress (key, raw chunk) pairs, or callables giving one, on a
    thread pool and put them in order."""
    from vla_touch_tpu_torch.utils import zarr2

    def encode(kv):
        key, raw = kv() if callable(kv) else kv
        return key, zarr2.encode_chunk(raw)

    threads = _io_threads()
    with ThreadPoolExecutor(threads) as pool:
        for key, data in _bounded_map(pool, encode, chunks, 2 * threads):
            writer.put(key, data)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def save_pytree_orbax(path: str, tree: Any, mesh=None) -> int:
    """Write ``tree`` (nested dicts / lists / tuples of numpy arrays,
    numbers, tensors, :class:`Shard` s and None) as orbax's
    StandardCheckpointer does, so that JAX's ``load_pytree_orbax`` reads
    it.  The directory is written beside ``path`` and renamed into place
    when complete (an existing ``path`` is replaced).  Chunks are
    compressed on a thread pool.  Returns the bytes this process wrote.

    In a process group of world > 1 this is collective, as orbax's save
    is in JAX's multi-process runs:
    every rank calls it with the same tree structure, its own shards as
    :class:`Shard` leaves (any other leaf is held whole by every rank) and
    the same ``mesh`` (a ``DeviceMesh``, recorded in ``_sharding``); see
    the note above.  Nothing is gathered."""
    if _world() > 1:
        return _RankWrite(path, tree, mesh).run()
    from vla_touch_tpu_torch.utils import ocdbt, zarr2

    path = os.path.abspath(path)
    t0 = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{t0}"
    try:
        writer = ocdbt.Writer(tmp)
        tree_meta, leaves = _orbax_entries(tree)
        chunks = []
        for name, vm, leaf in leaves:
            arr, dtype = zarr2.host_array(leaf)
            shape = zarr2.chunk_shape(arr.shape, arr.itemsize)
            writer.put(f"{name}/.zarray".encode(), zarr2.zarray(arr.shape, shape, dtype))
            chunks += zarr2.array_chunks(name, arr, shape)
            vm["write_shape"] = list(shape)
        _put_chunks(writer, chunks)
        nbytes = writer.commit() + _write_orbax_metadata(tmp, tree_meta, t0)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        return nbytes
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sharding_json(mesh, world: int, spec: tuple) -> str:
    """One leaf's ``_sharding`` entry: a DeviceMesh's axes and ranks (else
    one axis "data" over the world) and the leaf's spec."""
    if mesh is None:
        names, ranks = ["data"], np.arange(world)
    else:
        names, ranks = list(mesh.mesh_dim_names), mesh.mesh.numpy()
    return json.dumps({
        "sharding_type": "NamedSharding", "shape": list(ranks.shape), "axis_names": names,
        "axis_types": ["AxisType.Auto"] * len(names), "partition_spec": list(spec),
        "device_mesh": {"mesh": np.vectorize(lambda r: {"id": int(r)}, otypes=[object])(
            ranks).tolist()}})


# one array of a rank's write: its name, _METADATA value metadata, global
# shape, this rank's region and values (host numpy), spec and zarr dtype
_Array = collections.namedtuple("_Array", "name vm shape region spec values dtype")


class _RankWrite:
    """One collective write of a tree by every rank (see the note above).
    Made on the calling thread by every rank at once: this rank's shards
    on the host (copies with ``copy``: the caller goes on changing them)
    and one ``all_gather_object`` of every rank's regions and rank 0's
    temporary directory, from which each rank computes every array's
    chunk grid and the chunks it writes.  :meth:`run` writes, on
    any thread; the ranks then meet through the default process group's
    key-value store, not through the group's collectives, which training
    goes on issuing on the calling thread (a Gloo group for the writers
    alone would have to be made collectively on that thread and keep its
    own connections open; the store is already there, on every backend)."""

    def __init__(self, path: str, tree: Any, mesh=None, copy: bool = False):
        import torch.distributed as dist

        from vla_touch_tpu_torch.utils import zarr2

        self.path = os.path.abspath(path)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.t0 = time.time_ns()
        self.tree_meta, leaves = _orbax_entries(tree)
        self.arrays = []
        for name, vm, leaf in leaves:
            shard = leaf if isinstance(leaf, Shard) else None
            local = leaf if shard is None else shard.local
            values, dtype = zarr2.host_array(local)
            if copy and not (isinstance(local, torch.Tensor) and local.is_cuda):
                values = values.copy()      # a card tensor's host array is a copy already
            if shard is None:
                shape, region, spec = values.shape, zarr2.full_region(values.shape), ()
            else:
                shape, region, spec = (tuple(int(n) for n in shard.shape),
                                       tuple(tuple(map(tuple, r)) for r in shard.region),
                                       tuple(shard.spec))
            if zarr2.region_shape(region) != values.shape:
                raise ValueError(f"{name}: values of shape {values.shape} for a region of "
                                 f"{zarr2.region_shape(region)}")
            self.arrays.append(_Array(name, vm, shape, region, spec, values, dtype))
        tmp = f"{self.path}.orbax-checkpoint-tmp-{self.t0}-{os.getpid()}"
        every = [None] * self.world
        dist.all_gather_object(every, (tmp, [(a.name, a.shape, a.dtype, a.region)
                                             for a in self.arrays]))
        self.tmp = every[0][0]
        self.chunks, self.mine = self._plan([leaves for _, leaves in every])
        for a in self.arrays:
            a.vm["write_shape"] = list(self.chunks[a.name])
        self.mesh = mesh
        self.store = dist.distributed_c10d._get_default_store()
        self.key = f"orbax-checkpoint/{os.path.basename(self.tmp)}"

    def _plan(self, every: list) -> tuple:
        """({array: chunk shape}, {array: the chunk indices this rank
        writes}): a chunk is the largest run of any rank on each axis, and
        goes to the lowest rank that holds it.  Raises (on every rank
        alike) where the ranks' leaves differ or leave a chunk unheld."""
        from vla_touch_tpu_torch.utils import zarr2

        head = [leaf[:3] for leaf in every[0]]
        for r, leaves in enumerate(every):
            if [leaf[:3] for leaf in leaves] != head:
                raise ValueError(f"rank {r}'s leaves (names, shapes, dtypes) differ from "
                                 f"rank 0's")
        chunks, mine = {}, {}
        for i, (name, shape, _) in enumerate(head):
            regions = [leaves[i][3] for leaves in every]
            shape_c = tuple(max([b - a for reg in regions for a, b in reg[ax]] + [1])
                            for ax in range(len(shape)))
            owner = {}
            for r, reg in enumerate(regions):
                for idx in zarr2.region_chunk_indices(reg, shape_c, shape):
                    owner.setdefault(idx, r)
            grid = int(np.prod([-(-n // c) for n, c in zip(shape, shape_c)]))
            if len(owner) != grid:
                raise ValueError(f"{name}: the ranks hold {len(owner)} of its {grid} chunks")
            chunks[name] = shape_c
            mine[name] = sorted(idx for idx, r in owner.items() if r == self.rank)
        return chunks, mine

    def run(self) -> int:
        """Write this rank's part; rank 0 then joins every rank's and
        renames the directory into place.  Returns the bytes this rank
        wrote; raises on every rank when any rank failed (nothing is
        renamed into place then)."""
        error, nbytes = None, 0
        try:
            nbytes = self._write_rank()
        except BaseException as e:
            error = e
        self.store.set(f"{self.key}/rank{self.rank}",
                       "ok" if error is None else f"rank {self.rank}: {error!r}")
        if self.rank == 0:
            outcome, n = self._commit()
            nbytes += n
            self.store.set(f"{self.key}/commit", outcome)
        else:
            self.store.wait([f"{self.key}/commit"])
            outcome = self.store.get(f"{self.key}/commit").decode()
        if error is not None:
            raise error
        if outcome != "ok":
            raise RuntimeError(f"{self.path}: not committed ({outcome})")
        return nbytes

    def _write_rank(self) -> int:
        from vla_touch_tpu_torch.utils import ocdbt, zarr2

        writer = ocdbt.Writer(os.path.join(self.tmp, f"ocdbt.process_{self.rank}"))
        if self.rank == 0:
            for a in self.arrays:
                writer.put(f"{a.name}/.zarray".encode(),
                           zarr2.zarray(a.shape, self.chunks[a.name], a.dtype))

        def chunk(a, index):
            return lambda: zarr2.region_chunks(a.name, a.values, a.region, self.chunks[a.name],
                                               [index])[0]

        _put_chunks(writer, (chunk(a, idx) for a in self.arrays for idx in self.mine[a.name]))
        nbytes = writer.commit()
        os.makedirs(os.path.join(self.tmp, "array_metadatas"), exist_ok=True)
        nbytes += _write_json(
            os.path.join(self.tmp, "array_metadatas", f"process_{self.rank}"),
            {"array_metadatas": [{"array_metadata": {
                "param_name": a.name, "write_shape": a.vm["write_shape"],
                "chunk_shape": a.vm["write_shape"], "ext_metadata": None}}
                for a in self.arrays]})
        if self.rank == 0:
            sharding = {base64.b64encode(a.name.encode()).decode():
                        _sharding_json(self.mesh, self.world, a.spec) for a in self.arrays}
            nbytes += _write_json(os.path.join(self.tmp, ORBAX_SHARDING), sharding,
                                  separators=(",", ":"))
        return nbytes

    def _commit(self) -> tuple:
        """Rank 0, once every rank has reported: (outcome, bytes written)."""
        from vla_touch_tpu_torch.utils import ocdbt

        keys = [f"{self.key}/rank{r}" for r in range(self.world)]
        self.store.wait(keys)
        failed = [v for v in (self.store.get(k).decode() for k in keys) if v != "ok"]
        if failed:
            shutil.rmtree(self.tmp, ignore_errors=True)
            return "; ".join(failed), 0
        try:
            n = ocdbt.join(self.tmp, [f"ocdbt.process_{r}" for r in range(self.world)])
            n += _write_orbax_metadata(self.tmp, self.tree_meta, self.t0)
            if os.path.exists(self.path):
                shutil.rmtree(self.path)
            os.rename(self.tmp, self.path)
            return "ok", n
        except BaseException as e:
            shutil.rmtree(self.tmp, ignore_errors=True)
            return f"rank 0, joining: {e!r}", 0


def _flat_regions(tree, keys=()) -> dict:
    """{array name: region} of the Shards of a nested dict."""
    if isinstance(tree, dict):
        return {n: r for k, v in tree.items() for n, r in _flat_regions(v, keys + (str(k),)).items()}
    return {".".join(keys): tuple(tree.region)} if isinstance(tree, Shard) else {}


def load_pytree_orbax(path: str, target: Any = None, regions: Any = None,
                      stats: Optional[dict] = None) -> Any:
    """An orbax directory (JAX's ``save_pytree_orbax``, or the port's) as
    :func:`load_pytree` returns a msgpack file of the same tree: nested
    string-keyed dicts (sequence indices as "0", "1", ...), numpy arrays,
    bfloat16 leaves as torch tensors, None leaves as None and empty
    containers as {}.  Arrays are read on a thread pool.  With ``target``,
    restricted to its structure (keys and shapes validated).

    ``regions``: a nested dict like the tree; an array with a
    :class:`Shard` there comes back as the values of the Shard's region,
    read from the chunks it overlaps alone (any checkpoint topology: the
    chunks need not match the region).
    ``stats``: a dict that gets ``chunks_read`` and ``chunks_overlapped``
    added."""
    from vla_touch_tpu_torch.utils import ocdbt, zarr2

    path = os.path.abspath(path)
    meta = load_json(os.path.join(path, ORBAX_METADATA))
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT + zarr v2 checkpoints are read "
                         f"(use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')})")
    leaves, names = [], []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        vm = entry["value_metadata"]
        kind = vm["value_type"]
        if kind in _ARRAY_TYPES:
            names.append(".".join(keys))
        elif kind != "None" and kind not in _EMPTY_TYPES.values():
            raise ValueError(f"{path}: leaf {'/'.join(keys)} of value type {kind} is not read")
        leaves.append((keys, kind))
    region_of = {} if regions is None else _flat_regions(regions)
    with ocdbt.Database(path) as db, ThreadPoolExecutor(_io_threads()) as pool:
        read = list(pool.map(lambda n: zarr2.read_region(db, n, region_of.get(n), where=path),
                             names))
    arrays = {n: r[0] for n, r in zip(names, read)}
    if stats is not None:
        for k, i in (("chunks_read", 1), ("chunks_overlapped", 2)):
            stats[k] = stats.get(k, 0) + sum(r[i] for r in read)
    tree: dict = {}
    for keys, kind in leaves:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if kind == "None":
            value = None
        elif kind in _EMPTY_TYPES.values():
            value = {}
        else:
            value = arrays[".".join(keys)]
        node[keys[-1]] = value
    return tree if target is None else _match(tree, target)


def take_regions(tree: Any, regions: Any) -> Any:
    """``tree`` (whole leaves, e.g. :func:`load_pytree`'s) in the structure
    of ``regions``, a nested dict like it: where ``regions`` has a
    :class:`Shard`, that Shard's region of the array; elsewhere the leaf
    as it is."""
    from vla_touch_tpu_torch.utils import zarr2

    if isinstance(regions, dict):
        return {k: take_regions(tree[str(k)], v) for k, v in regions.items()}
    if isinstance(regions, Shard):
        return zarr2.take_region(tree, regions.region)
    return tree


def _host_copy(tree):
    """A host copy of every array leaf (tensors and numpy arrays alike)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncOrbaxSaver:
    """Overlapped :func:`save_pytree_orbax` writes.  ``save`` waits for the
    previous write (at most one in flight), copies the tree (at world > 1:
    this rank's shards) to host memory and writes it on a background
    thread; ``wait`` blocks until it has landed and re-raises its failure
    (at world > 1, any rank's); call ``close`` (or ``wait``) before the
    process exits.  At world > 1 ``save`` is collective, as
    :func:`save_pytree_orbax`: every rank calls it at the same point of
    its program."""

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path: str, tree: Any, mesh=None) -> None:
        self.wait()
        if _world() > 1:
            write = _RankWrite(path, tree, mesh, copy=True).run
        else:
            host = _host_copy(tree)

            def write():
                save_pytree_orbax(path, host)

        def run():
            try:
                write()
            except BaseException as e:  # raised by wait
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async orbax checkpoint write failed") from err

    def close(self) -> None:
        self.wait()


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
