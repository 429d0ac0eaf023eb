"""Megatron tensor parallelism over the mesh's ``model`` axis (the
counterpart of the all-reduces GSPMD inserts for JAX's ``_rdt_tp_spec``,
``llm_tp_spec`` and ``t5_tp_spec``).

A column-parallel product holds its rank's output features and a
row-parallel one its input features; between them activations stay local
(each rank's heads).  Two autograd functions carry the sums:

- :func:`copy_to` at a column-parallel input: identity forward, the
  gradient summed over the model ranks backward;
- :func:`reduce_from` after a row-parallel output: the partial products
  summed forward, identity backward.

A fused projection is split head-aligned: a rank's rows of ``qkv`` are
its heads' rows of q, of k and of v (JAX's spec splits the fused output
axis as one; for explicit TP that would give rank 0 all of q).  The
gathered tensor is the same.

Biases stay whole on every rank (JAX's spec replicates them): a
column-parallel layer adds its rows of the bias, so the bias's gradient on
one rank covers only those rows, and the per-head ``q_norm`` / ``k_norm``
scales see only the rank's heads.  Those gradients are partial sums over
the model ranks (:func:`rdt_model_partial`); the sharded train step sums
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vla_touch_tpu_torch.ops.nn import CastLinear
from vla_touch_tpu_torch.parallel import mesh as mesh_lib
from vla_touch_tpu_torch.parallel.comm import Piece, all_gather_list, all_reduce_sum


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x, group):
    """Identity forward; gradient all-reduced over ``group`` backward."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Sum over ``group`` forward; identity backward."""
    return _ReduceFrom.apply(x, group)


def gather_last(x, group):
    """The last axis concatenated over ``group``'s ranks (e.g. logits split
    by vocabulary)."""
    return torch.cat(all_gather_list(x, group), dim=-1)


def vocab_lookup(table, ids, start: int, group):
    """Rows ``ids`` of a table split by rows over ``group`` (this rank holds
    rows [start, start + len(table))): the local rows where they fall, 0
    elsewhere, summed over the ranks."""
    local = ids - start
    valid = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(local.clamp(0, table.shape[0] - 1), table)
    return reduce_from(rows * valid[..., None].to(rows.dtype), group)


class _ParallelLinear(nn.Linear):
    """A Linear holding one piece of its weight and the whole bias; it
    computes as the layer it replaces (a :class:`CastLinear`'s casts, or
    ``nn.Linear``'s)."""

    def __init__(self, src: nn.Linear, piece: Piece):
        nn.Module.__init__(self)
        w = piece.take(src.weight.detach())
        self.out_features, self.in_features = w.shape
        self.weight = nn.Parameter(w, requires_grad=src.weight.requires_grad)
        self.bias = src.bias
        self.register_buffer("index", piece.index[piece.rank].clone(), persistent=False)
        self.group = piece.group
        self.cast_dtype = src.compute_dtype if isinstance(src, CastLinear) else None


class ColumnParallelLinear(_ParallelLinear):
    """Output features ``index`` (this rank's heads / hidden units)."""

    def forward(self, x):
        x = copy_to(x, self.group)
        bias = None if self.bias is None else self.bias[self.index]
        if self.cast_dtype is None:
            return F.linear(x, self.weight, bias)
        cd = self.cast_dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if bias is None else y + bias.to(cd)


class RowParallelLinear(_ParallelLinear):
    """Input features ``index``; the partial products summed over the model
    ranks, then the bias added."""

    def forward(self, x):
        if self.cast_dtype is None:
            y = reduce_from(F.linear(x, self.weight), self.group)
            return y if self.bias is None else y + self.bias
        cd = self.cast_dtype
        y = reduce_from(F.linear(x.to(cd), self.weight.to(cd)), self.group)
        return y if self.bias is None else y + self.bias.to(cd)


# ---- the RDT blocks ---------------------------------------------------------------


def _segments(name: str) -> int:
    if name.endswith(".attn.qkv.weight"):
        return 3
    if name.endswith(".cross_attn.kv.weight"):
        return 2
    return 1


def rdt_tp_pieces(mesh, module) -> dict:
    """name -> the model axis's :class:`Piece` of each TP-sharded RDT
    parameter (``mesh.rdt_param_shardings``; fused projections split
    head-aligned).  Empty when the model axis is 1."""
    _, n_model = mesh_lib.mesh_sizes(mesh)
    if n_model == 1:
        return {}
    specs = mesh_lib.rdt_param_shardings(mesh, module)
    shapes = {n: p.shape for n, p in module.named_parameters()}
    group, rank = mesh_lib.group(mesh, mesh_lib.MODEL_AXIS), mesh_lib.model_index(mesh)
    out = {}
    for name, spec in specs.items():
        if mesh_lib.MODEL_AXIS in spec:
            axis = spec.index(mesh_lib.MODEL_AXIS)
            out[name] = Piece.split(axis, shapes[name][axis], group, rank, n_model,
                                    _segments(name))
    return out


def rdt_model_partial(module, pieces: dict) -> set:
    """The names whose gradient one model rank holds only part of: the
    biases of the column-parallel linears in ``pieces`` (JAX's rule also
    takes the final MLP's ``final_ffn/fc1``) and the blocks' per-head q / k
    norm scales."""
    if not pieces:
        return set()
    names = {n for n, _ in module.named_parameters()}
    out = {n[: -len("weight")] + "bias" for n, pc in pieces.items() if pc.axis == 0}
    for i in range(len(module.model.blocks)):
        out |= {f"model.blocks.{i}.{a}.{q}_norm.weight" for a in ("attn", "cross_attn")
                for q in "qk"}
    return out & names


def shard_rdt_tp_(module, mesh, pieces=None) -> dict:
    """Put each RDT block's TP-sharded linears (``rdt_tp_pieces``) on this
    rank's piece, in place: ``attn.qkv``, ``cross_attn.q`` / ``.kv`` and
    ``ffn.fc1`` column-parallel, the ``proj``s and ``ffn.fc2``
    row-parallel (JAX's rule matches ``final_ffn`` too: its fc1 and fc2
    split alike).  Works on serving and training runners alike.  Returns
    the pieces."""
    pieces = rdt_tp_pieces(mesh, module) if pieces is None else pieces
    for name, piece in pieces.items():
        path = name[: -len(".weight")].split(".")
        parent = module.get_submodule(".".join(path[:-1]))
        src = getattr(parent, path[-1])
        cls = ColumnParallelLinear if piece.axis == 0 else RowParallelLinear
        setattr(parent, path[-1], cls(src, piece))
    return pieces
