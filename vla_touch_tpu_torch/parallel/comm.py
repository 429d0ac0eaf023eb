"""The collectives of the port's parallel paths, and one mesh axis's
slicing of a tensor.

Only ``all_reduce`` and ``all_gather`` (the list form) are used: NCCL and
Gloo both take them on CPU and CUDA tensors (two ranks sharing one card
run over Gloo, which moves CUDA tensors through the host).  A
reduce-scatter is an ``all_reduce`` and this rank's slice, on both
backends.  Sums of bf16 / fp16 tensors are taken in float32 and rounded
once.  A process without a process group is a world of one (``group``
None): the sum is a copy and the gather the tensor itself.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group`` (float32 for narrower
    floats, cast back)."""
    y = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x.clone()
    if _distributed(group):
        dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _distributed(group) -> bool:
    return group is not None or dist.is_initialized()


def all_gather_list(x: torch.Tensor, group=None) -> list:
    """Every rank's ``x`` (same shape on each), in group-rank order."""
    if not _distributed(group):
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def split_index(size: int, n: int, segments: int = 1) -> torch.Tensor:
    """(n, size // n) positions: part r of each of ``segments`` equal
    contiguous segments, for rank r.  ``segments`` > 1 is the head-aligned
    split of a fused projection (q, k, v each split by heads)."""
    seg = size // segments
    if seg * segments != size or seg % n:
        raise ValueError(f"axis of {size} does not split into {segments} segments of "
                         f"{n} parts")
    part = seg // n
    return torch.stack([torch.cat([s * seg + r * part + torch.arange(part)
                                   for s in range(segments)]) for r in range(n)])


@dataclasses.dataclass(eq=False)
class Piece:
    """One mesh axis's slicing of a tensor: along ``axis`` (of size
    ``size``), rank r of ``group`` holds the positions ``index[r]``;
    ``rank`` is this process's rank in the group."""

    axis: int
    size: int
    index: torch.Tensor
    group: object
    rank: int

    @classmethod
    def split(cls, axis: int, size: int, group, rank: int, n: int, segments: int = 1):
        return cls(axis, size, split_index(size, n, segments), group, rank)

    @property
    def whole(self) -> bool:
        """One part: the piece is the whole tensor."""
        return self.index.shape[0] == 1

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's positions of the full ``t`` (a new tensor; ``t``
        itself when the piece is whole)."""
        if self.whole:
            return t
        return t.index_select(self.axis, self.index[self.rank].to(t.device))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's piece ``t`` (collective; ``t``
        itself when the piece is whole)."""
        if self.whole:
            return t
        parts = all_gather_list(t, self.group)
        shape = list(t.shape)
        shape[self.axis] = self.size
        out = t.new_empty(shape)
        for r, p in enumerate(parts):
            out.index_copy_(self.axis, self.index[r].to(t.device), p)
        return out


class GatherFn(torch.autograd.Function):
    """ZeRO-3's gather of a parameter shard: the full tensor forward; the
    gradient summed over the group and this rank's slice backward (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, shard, piece: Piece):
        ctx.piece = piece
        return shard.detach().clone() if piece.whole else piece.gather(shard.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.piece.take(all_reduce_sum(g, ctx.piece.group)), None
