"""Device mesh and sharding rules (counterpart of
``vla_touch_tpu/parallel/mesh.py``).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("data", "model")``: data-parallel ranks split the batch, and the
``model`` ranks of one data index split the RDT blocks' matmuls
(Megatron tensor parallelism, :mod:`parallel.tp`).  Rank ``d * n_model +
m`` sits at (d, m), as JAX's ``make_mesh`` reshapes its devices.

The rules are JAX's, as tables of specs keyed by the port's parameter
names: a spec is a tuple naming the mesh axis each tensor axis is split
over (None: not split; ``()``: replicated), JAX's ``PartitionSpec`` as a
tuple.  Each name goes to its flax path through
``utils/from_flax.py::flax_paths``, where JAX's rule is applied; a torch
``Linear.weight`` is (N, K) where flax's kernel is (K, N), so its spec
comes back transposed.  The functions take a mesh or its sizes ``(n_data,
n_model)``.
"""

from __future__ import annotations

from typing import Optional

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """A ``(data, model)`` DeviceMesh over the default process group's
    ranks (``n_data`` defaults to world / ``n_model``), on the device type
    :func:`launch.initialize` chose."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from vla_touch_tpu_torch.parallel import launch

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) does not cover the {world} ranks")
    return init_device_mesh(launch.local_device().type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_sizes(mesh) -> tuple:
    """(n_data, n_model) of a DeviceMesh, a sizes pair, or None (one rank)."""
    if mesh is None:
        return 1, 1
    if isinstance(mesh, tuple):
        return int(mesh[0]), int(mesh[1])
    names = mesh.mesh_dim_names
    return (int(mesh.shape[names.index(DATA_AXIS)]), int(mesh.shape[names.index(MODEL_AXIS)]))


def data_index(mesh) -> int:
    return 0 if mesh is None or isinstance(mesh, tuple) else mesh.get_local_rank(DATA_AXIS)


def model_index(mesh) -> int:
    return 0 if mesh is None or isinstance(mesh, tuple) else mesh.get_local_rank(MODEL_AXIS)


def group(mesh, axis: str):
    """The process group of this rank's line along ``axis`` (None without a
    mesh: one rank)."""
    return None if mesh is None or isinstance(mesh, tuple) else mesh.get_group(axis)


# ---- the rules, on flax paths and JAX layouts ----------------------------------


def _rdt_tp_spec(path: tuple) -> tuple:
    """Megatron rules for RDT block parameters (JAX's ``_rdt_tp_spec``):
    column-parallel (output features) qkv / q / kv projections and MLP fc1,
    row-parallel (input features) the attention projections and MLP fc2;
    kernels only."""
    keys = [str(k) for k in path]
    name = "/".join(keys)
    if not keys or keys[-1] != "kernel":
        return ()
    if any(s in name for s in ("attn/qkv", "cross_attn/q/", "cross_attn/kv", "ffn/fc1")):
        return (None, MODEL_AXIS)
    if any(s in name for s in ("attn/proj", "cross_attn/proj", "ffn/fc2")):
        return (MODEL_AXIS, None)
    return ()


def zero_spec_for(shape: tuple, n_data: int, base: Optional[tuple] = None) -> tuple:
    """Shard the largest free axis divisible by ``n_data`` over data (ties:
    the first); ``base`` (e.g. a TP spec) marks axes already taken.  Falls
    back to ``base`` (or replication) when no axis divides: the one policy
    of ZeRO-2 moments and ZeRO-3 parameters."""
    shape = tuple(shape)
    if not shape:
        return tuple(base) if base is not None else ()
    spec = list(base) if base is not None else []
    spec = spec + [None] * (len(shape) - len(spec))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % n_data == 0 and shape[i] >= n_data:
            spec[i] = DATA_AXIS
            return tuple(spec)
    return tuple(base) if base is not None else ()


def transpose_spec(spec: tuple, transposed: bool) -> tuple:
    """A 2-D leaf's spec in the other layout (flax kernel <-> torch weight)."""
    return tuple(reversed(spec)) if transposed and spec else tuple(spec)


# ---- the tables, keyed by the port's names --------------------------------------


def _leaves(module: torch.nn.Module) -> dict:
    """name -> (torch shape, flax path, transposed) of ``module``'s
    parameters (the full, unsharded module)."""
    from vla_touch_tpu_torch.utils.from_flax import flax_paths

    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    return {n: (shapes[n], path, t) for n, (path, t) in flax_paths(module).items()}


def _jshape(shape, transposed) -> tuple:
    return tuple(reversed(shape)) if transposed else tuple(shape)


def rdt_param_shardings(mesh, module) -> dict:
    """name -> spec of the RDT runner's parameters: TP over the block
    matmuls when the mesh has a model axis > 1, replicated otherwise."""
    _, n_model = mesh_sizes(mesh)
    return {n: (transpose_spec(_rdt_tp_spec(path), t) if n_model > 1 else ())
            for n, (_, path, t) in _leaves(module).items()}


def fsdp_param_shardings(mesh, module) -> dict:
    """ZeRO-3: every parameter also sharded over data on its largest free
    axis (:func:`zero_spec_for` with the TP spec as base when the mesh has
    a model axis > 1)."""
    n_data, n_model = mesh_sizes(mesh)
    out = {}
    for n, (shape, path, t) in _leaves(module).items():
        tp = _rdt_tp_spec(path) if n_model > 1 else ()
        out[n] = transpose_spec(zero_spec_for(_jshape(shape, t), n_data, base=tp), t)
    return out


def zero_sharding(mesh, shapes: dict, transposed=frozenset()) -> dict:
    """ZeRO-2: name -> spec of optimizer-state leaves (``shapes``: name ->
    torch shape; names in ``transposed`` are laid out as their transpose in
    the JAX tree, e.g. AdamW's moments of a Linear weight), sharded over
    data by :func:`zero_spec_for`."""
    n_data, _ = mesh_sizes(mesh)
    return {n: transpose_spec(zero_spec_for(_jshape(s, n in transposed), n_data),
                              n in transposed)
            for n, s in shapes.items()}
