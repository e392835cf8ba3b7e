"""Collectives with gradients, the same on gloo (CPU) and NCCL (CUDA).

Each is a `torch.autograd.Function` over `dist.all_reduce` or
`dist.all_gather` on a process group (a mesh axis, `mesh.axis_group`); a
group of None or of one rank makes each the identity.

- `all_reduce_sum(x, group)`: every rank gets the sum; the gradient is
  the sum of the ranks' gradients (each rank's loss reads the sum).
- `all_reduce_mean(x, group)`: the same over the group's size.
- `gather(x, dim, group)`: the ranks' tensors concatenated along `dim`
  in rank order.  Its gradient is the rank's own slice of the output's
  gradient: what follows a gather runs replicated on every rank of the
  group, and each holds the same gradient (Megatron's "g").
- `copy_to(x, group)`: the identity, whose gradient is summed over the
  group (Megatron's "f", ahead of a column-parallel layer whose ranks
  each see only their slice of the output).

Also the data-parallel pieces: `all_reduce_grads` (one flat all-reduce
of the gradients, as a sum or a mean) and `sync_batch_norm` (a batch
norm whose mean and biased variance are those of the group's global
batch).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class GroupRef:
    """A process group as modules hold it: a deep copy of the module
    shares the group (a process group cannot be copied or pickled)."""

    __slots__ = ("pg",)

    def __init__(self, pg):
        self.pg = pg

    def __deepcopy__(self, memo):
        return self


def _pg(group):
    return group.pg if isinstance(group, GroupRef) else group


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(_pg(group))


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(_pg(group))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=_pg(group))
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_pg(ctx.group))
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = group_size(group)
        ctx.dim, ctx.index = dim, group_rank(group)
        ctx.size = x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=_pg(group))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.index, ctx.size
        return g.narrow(ctx.dim, i * n, n).contiguous(), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_pg(ctx.group))
        return g, None


def all_reduce_sum(x, group):
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x, group):
    n = group_size(group)
    return x if n == 1 else _AllReduceSum.apply(x, group) / n


def gather(x, dim: int, group):
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), group)


def copy_to(x, group):
    if group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


@torch.no_grad()
def all_reduce_grads(params, group, op: str = "mean"):
    """All-reduce the gradients of `params` over `group` in one flat
    buffer: "mean" for a loss that is a mean over the batch (each rank's
    loss the mean over its rows), "sum" for one that is a sum over the
    batch over a constant (each rank's loss its rows' share)."""
    if op not in ("mean", "sum"):
        raise ValueError(f"unknown gradient reduction {op!r}")
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    n = group_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=_pg(group))
    if op == "mean":
        flat /= n
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(parts, grads)])


def sync_batch_norm(x, weight, bias, eps: float, group):
    """Batch norm of NCHW `x` with the mean and biased variance over (N, H,
    W) of the global batch, the rows of every rank of `group`: (y, mean,
    var, n) with n the global count per channel.  Two passes, each one
    all-reduce (and one more of each in the backward).  The ranks' batches
    must be of one size."""
    n = x.numel() // x.shape[1] * group_size(group)
    xf = x.float()
    mean = all_reduce_sum(xf.sum(dim=(0, 2, 3)), group) / n
    d = xf - mean[None, :, None, None]
    var = all_reduce_sum((d * d).sum(dim=(0, 2, 3)), group) / n
    y = d * torch.rsqrt(var + eps)[None, :, None, None]
    if weight is not None:
        y = y * weight[None, :, None, None] + bias[None, :, None, None]
    return y.to(x.dtype), mean, var, n
