"""Tensor (channel) parallelism and the data-parallel batch norms.

Counterpart of the JAX `mesh.shard_params_tp` under GSPMD, which shards
the output-channel axis of every kernel, bias and batch-norm vector that
divides the `model` axis and lets XLA insert the collectives.  Here that
is written out Megatron's way: `tensor_parallel(model, group)` replaces
every `Conv2d`, `Linear` and darknet `ConvLayer` whose output channels
`mesh.tp_shard` splits with a `ColumnParallel` layer.  That layer keeps
only this rank's slice of the output channels (weight, bias, and the
batch norm of a `ConvLayer`), computes that slice from the whole input,
and all-gathers along the channels, so the next layer sees the whole map
(`collectives.gather`; its input passes through `collectives.copy_to`,
whose gradient sums the ranks' parts).  Indivisible layers stay whole and
run replicated.  Forward and backward both work: the DP x TP train step
of `entry.dryrun_multichip` runs through it.

`set_batch_norm_group(model, group)` points every batch norm of the
port's networks at a data-parallel group (`collectives.sync_batch_norm`).
"""

from __future__ import annotations

import copy

import torch.nn as nn
import torch.nn.functional as F

from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.parallel import collectives as coll
from betapose_tpu_torch.parallel.mesh import tp_shard


def _slice_param(owner, name, size, index):
    t = getattr(owner, name, None)
    if t is None:
        return
    part = tp_shard(t.detach(), size, index).clone()
    if isinstance(t, nn.Parameter):
        setattr(owner, name, nn.Parameter(part, t.requires_grad))
    else:
        owner.register_buffer(name, part)


def _out_channels(m) -> int:
    if isinstance(m, yolo_mod.ConvLayer):
        return m.conv.out_channels
    return m.out_channels if isinstance(m, nn.Conv2d) else m.out_features


class ColumnParallel(nn.Module):
    """This rank's slice of the output channels of `module` (a Conv2d, a
    Linear or a darknet ConvLayer), all-gathered over `group` along the
    channels (dim 1)."""

    def __init__(self, module, group):
        super().__init__()
        size, index = coll.group_size(group), coll.group_rank(group)
        inner = copy.deepcopy(module)
        convs = [inner.conv] if isinstance(inner, yolo_mod.ConvLayer) \
            else [inner]
        for c in convs:
            for name in ("weight", "bias"):
                _slice_param(c, name, size, index)
            if isinstance(c, nn.Conv2d):
                c.out_channels //= size
            else:
                c.out_features //= size
        bn = getattr(inner, "bn", None)
        if bn is not None:
            for name in ("weight", "bias", "running_mean", "running_var"):
                _slice_param(bn, name, size, index)
            bn.num_features //= size
        self.inner, self.group = inner, group

    def forward(self, x, padding=None):
        x = coll.copy_to(x, self.group)
        return coll.gather(conv_forward(self.inner, x, padding), 1,
                           self.group)


def conv_forward(m, x, padding=None):
    """m(x), with the conv's padding replaced by `padding` when given; m a
    Conv2d, a darknet ConvLayer or a ColumnParallel of either."""
    if padding is None:
        return m(x)
    if isinstance(m, (ColumnParallel, yolo_mod.ConvLayer)):
        return m(x, padding)
    return F.conv2d(x, m.weight, m.bias, m.stride, padding, m.dilation,
                    m.groups)


def tensor_parallel(model: nn.Module, group) -> nn.Module:
    """A copy of `model` whose Conv2d, Linear and darknet ConvLayer
    modules with output channels divisible by the group's size (and at
    least as many) are `ColumnParallel` over `group`; the rest is as it
    was.  Each rank keeps only its slice of those layers' weights.  With
    no group (or one of one rank), `model` itself."""
    size = coll.group_size(group)
    if size == 1:
        return model
    model = copy.deepcopy(model)

    def wrap(parent):
        for name, child in parent.named_children():
            if isinstance(child, (yolo_mod.ConvLayer, nn.Conv2d, nn.Linear)):
                c = _out_channels(child)
                if c >= size and c % size == 0:
                    setattr(parent, name, ColumnParallel(child, group))
            else:
                wrap(child)

    wrap(model)
    return model


def set_batch_norm_group(model: nn.Module, group) -> nn.Module:
    """Point every batch norm of `model` that can synchronize (the port's
    darknet, FastPose and PyraNet batch norms) at `group`; None turns
    synchronization off."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d) and hasattr(type(m), "group"):
            m.group = group
    return model
