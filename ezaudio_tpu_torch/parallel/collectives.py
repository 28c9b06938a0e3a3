"""The differentiable collectives of the tensor-parallel linears
(Megatron's ``f`` and ``g``) and the all-gather of rows.

``copy_to_group``: identity forward, all-reduce (sum) of the gradient
backward; it stands before a column-parallel linear, whose input every
rank of the group holds whole.  ``reduce_from_group``: all-reduce (sum)
forward, identity backward; it ends a row-parallel linear, whose ranks
each hold a partial sum.  Neither does anything for a group of one.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    rank order; not differentiable."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
