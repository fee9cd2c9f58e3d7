"""The hand-written collectives of sharded execution.

The reference lets GSPMD insert these from the arrays' shardings; the port
holds each rank's local shard as a plain tensor and writes them out:

* Megatron tensor parallelism (``TensorParallel``): ``copy_to_tp`` before
  a column-parallel product (identity forward, all-reduce of the input
  gradient backward) and ``reduce_from_tp`` after a row-parallel one
  (all-reduce forward, identity backward), over the mesh's 'model' group.
* Coalesced collectives over many tensors at once, each split along its
  own axis: ``gather_slices`` (all-gather, and its reduce-scatter
  backward, for FSDP), ``scatter_grads`` (reduce-scatter, ZeRO-1) and
  ``all_reduce_coalesced`` (data-parallel gradients).
* ``FSDPBlock``: one layer's FSDP slices, gathered where the layer runs
  and again when the backward recomputes it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import distributed as D


@dataclass(frozen=True)
class TensorParallel:
    """A rank's place in its tensor-parallel ('model') group."""

    group: object
    size: int
    rank: int

    def heads(self, n_head: int) -> int:
        """Local head count of a column-sharded attention."""
        return n_head // self.size


def local_heads(n_head: int, tp: Optional[TensorParallel]) -> int:
    return n_head if tp is None else tp.heads(n_head)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.all_reduce(g.contiguous().clone(), ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return D.all_reduce(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x, tp: Optional[TensorParallel]):
    """Input of a column-parallel product (identity without TP)."""
    if tp is None or not x.requires_grad:
        return x
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: Optional[TensorParallel]):
    """Sum of a row-parallel product's partial outputs over 'model'."""
    if tp is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, tp)
    return D.all_reduce(x.contiguous().clone(), tp.group)


# -- coalesced collectives over tensors split along their own axes ---------


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def all_gather_coalesced(slices: Sequence[torch.Tensor], axes: Sequence[int],
                         group) -> List[torch.Tensor]:
    """Each slice gathered over the group along its axis, in one
    all-gather a dtype: the flat slices are joined, gathered as (n, M),
    and each tensor's columns reassembled block by block."""
    n = D.group_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(slices)
    for idx in _by_dtype(slices).values():
        fronts = [slices[i].movedim(axes[i], 0) for i in idx]
        flat = torch.cat([f.reshape(-1) for f in fronts])
        full = D.all_gather(flat[None], group).reshape(n, -1)
        off = 0
        for i, f in zip(idx, fronts):
            m = f.numel()
            block = full[:, off:off + m].reshape((n * f.shape[0],) + f.shape[1:])
            out[i] = block.movedim(0, axes[i]).contiguous()
            off += m
    return out


def reduce_scatter_coalesced(fulls: Sequence[torch.Tensor], axes: Sequence[int],
                             group) -> List[torch.Tensor]:
    """Each tensor summed over the group, this rank keeping its block of
    its axis, in one reduce-scatter a dtype."""
    n = D.group_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(fulls)
    for idx in _by_dtype(fulls).values():
        fronts = [fulls[i].movedim(axes[i], 0) for i in idx]
        rows = torch.cat([f.reshape(n, -1) for f in fronts], dim=1)
        mine = D.reduce_scatter(rows, group).reshape(-1)
        off = 0
        for i, f in zip(idx, fronts):
            shape = (f.shape[0] // n,) + f.shape[1:]
            m = int(torch.Size(shape).numel())
            out[i] = mine[off:off + m].reshape(shape).movedim(0, axes[i]).contiguous()
            off += m
    return out


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over the group, one all-reduce a dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        D.all_reduce(flat, group)
        off = 0
        for i in idx:
            m = tensors[i].numel()
            out[i] = flat[off:off + m].view_as(tensors[i])
            off += m
    return out


class _GatherSlices(torch.autograd.Function):
    """FSDP's all-gather; its backward reduce-scatters the gradients."""

    @staticmethod
    def forward(ctx, axes, group, *slices):
        ctx.axes, ctx.group = axes, group
        ctx.shapes = [(s.shape, s.dtype, s.device) for s in slices]
        return tuple(all_gather_coalesced(slices, axes, group))

    @staticmethod
    def backward(ctx, *grads):
        n = D.group_size(ctx.group)
        fulls = []
        for g, (shape, dtype, device), a in zip(grads, ctx.shapes, ctx.axes):
            if g is None:
                full_shape = list(shape)
                full_shape[a] *= n
                g = torch.zeros(full_shape, dtype=dtype, device=device)
            fulls.append(g)
        return (None, None, *reduce_scatter_coalesced(fulls, ctx.axes, ctx.group))


def gather_slices(slices: Sequence[torch.Tensor], axes: Sequence[int],
                  group) -> Tuple[torch.Tensor, ...]:
    """All-gather FSDP slices (differentiable: the backward reduce-scatters)."""
    if not slices:
        return ()
    if torch.is_grad_enabled() and any(s.requires_grad for s in slices):
        return _GatherSlices.apply(tuple(axes), group, *slices)
    with torch.no_grad():
        return tuple(all_gather_coalesced(slices, axes, group))


class FSDPBlock(dict):
    """One layer's parameters with FSDP slices: {name: tensor} as the
    layer's dict, plus ``axes`` {dotted name: axis} for the sliced ones.
    ``materialize()`` returns the plain dict with the slices gathered;
    ``models.whisper`` calls it inside the layer's checkpoint, so the
    gather runs again when the backward recomputes the layer."""

    def __init__(self, tree, axes: Dict[str, int], group):
        super().__init__(tree)
        self.axes = axes
        self.group = group

    def materialize(self) -> dict:
        from ..models.convert import flatten_params, unflatten_params

        flat = flatten_params(dict(self))
        names = [n for n in flat if n in self.axes]
        full = gather_slices([flat[n] for n in names],
                             [self.axes[n] for n in names], self.group)
        flat.update(zip(names, full))
        return unflatten_params(flat)
