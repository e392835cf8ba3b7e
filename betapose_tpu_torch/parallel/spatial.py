"""Spatial partitioning: one frame's rows split over the mesh's `space`
axis, the latency path for small batches where data parallelism has
nothing to split.

Counterpart of the JAX `frame_sharded` placement, under which GSPMD
partitions every convolution spatially and inserts the halo exchanges.
Here the split is made by module wrappers, as `layers.tensor_parallel`
makes the channel split, and the networks keep their own forward:
`split_rows(model, space)` wraps, in a copy of a darknet or a FastPose,

- every conv and max pool with a kernel or stride > 1 (`_Window`): it
  takes from its neighbours the rows its window reaches beyond the band,
  with the stride and padding accounted for (one all-gather of each
  rank's first and last rows, as many as the widest halo of the layer),
  the image edges padded as the layer pads (zeros, or -inf for a pool);
- the layers that scale the rows, nearest upsampling and pixel shuffle
  (`_Rescale`);
- the SE squeeze, whose spatial mean is all-reduced over `space`
  (`_Mean`), and each yolo head, gathered whole (`_Whole`), so the best
  box and the crop run on every rank of `space`.

Row-local layers (1x1 convs at stride 1, batch norms, activations, the
residual sums and the channel concatenations) run on the band as they
are.  A map of global height h is split iff h divides by the group's
size, each rank then holding its band of h / n rows; otherwise it is
whole on every rank (YOLOv3-416 reaches 13 rows at /32, FastPose's
320-row crop 10).  Both operands of a sum or a concatenation have one
height, so they are split or whole alike.  A windowed layer whose halo
outgrows the band runs on the gathered map and keeps its band of the
output.  The result is the single-device one either way.

A wrapper reads its input's global height from a plan: the first call
of a `SplitNetwork` at an input shape runs the network once whole, on
the first frame, and records each wrapper's input height.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn
import torch.nn.functional as F

from betapose_tpu_torch.models import kpd as kpd_mod
from betapose_tpu_torch.models import yolov3 as yolo_mod
from betapose_tpu_torch.parallel import collectives as coll
from betapose_tpu_torch.parallel.layers import ColumnParallel, conv_forward


class Space:
    """The spatial split over a process group (a mesh's `space` axis)."""

    def __init__(self, group):
        self.group = group
        self.n = coll.group_size(group)
        self.i = coll.group_rank(group)
        self.plan = {}          # wrapper -> global input height
        self.planning = False

    def splits(self, h: int) -> bool:
        return self.n > 1 and h % self.n == 0

    def band(self, x, dim: int):
        """This rank's band of the whole map x along `dim`."""
        b = x.shape[dim] // self.n
        return x.narrow(dim, self.i * b, b)

    def whole(self, x, dim: int):
        """The whole map of the bands x along `dim`."""
        return coll.gather(x, dim, self.group)

    def height(self, m, x):
        """The global height of wrapper m's input x; None in the planning
        pass, which records it from the whole map."""
        if self.planning:
            self.plan[m] = x.shape[2]
            return None
        return self.plan[m]


def _geometry(m):
    """(kernel, stride, padding) rows and the column padding of a conv or
    a max pool."""
    while isinstance(m, (ColumnParallel, yolo_mod.ConvLayer)):
        m = m.inner if isinstance(m, ColumnParallel) else m.conv
    if isinstance(m, nn.MaxPool2d):
        return m.kernel_size, m.stride, m.padding, m.padding
    return m.kernel_size[0], m.stride[0], m.padding[0], m.padding[1]


class _Window(nn.Module):
    """A conv (or darknet ConvLayer, or either column-parallel) or a max
    pool with a kernel or stride > 1, on split rows."""

    def __init__(self, inner, space: Space):
        super().__init__()
        self.inner, self.space = inner, space
        self.k, self.s, self.p, self.pw = _geometry(inner)
        self.pool = isinstance(inner, nn.MaxPool2d)

    def forward(self, x):
        sp = self.space
        h = sp.height(self, x)
        if h is None:
            return self.inner(x)
        h_out = (h + 2 * self.p - self.k) // self.s + 1
        if sp.splits(h) and sp.splits(h_out):
            y = self._on_band(x, h_out)
            if y is not None:
                return y
        y = self.inner(sp.whole(x, 2) if sp.splits(h) else x)
        return sp.band(y, 2) if sp.splits(h_out) else y

    def _on_band(self, x, h_out):
        """The layer on this rank's band with its halo rows, or None when
        a halo is taller than a band."""
        sp, k, s, p = self.space, self.k, self.s, self.p
        hb, ob = x.shape[2], h_out // sp.n

        def halo(i):   # rows needed above and below rank i's band
            lo = i * ob * s - p
            hi = ((i + 1) * ob - 1) * s - p + k
            return i * hb - lo, hi - (i + 1) * hb

        need = [halo(i) for i in range(sp.n)]
        t = max(max(a, b, 0) for a, b in need)
        if t > hb:
            return None
        top, bot = need[sp.i]
        if t:
            fill = float("-inf") if self.pool else 0.0
            edges = coll.gather(
                torch.cat([x[:, :, :t], x[:, :, hb - t:]], 2), 2, sp.group)
            parts = []
            if top > 0:
                parts.append(
                    x.new_full((*x.shape[:2], top, x.shape[3]), fill)
                    if sp.i == 0 else
                    edges[:, :, sp.i * 2 * t - top:sp.i * 2 * t])
            parts.append(x[:, :, max(-top, 0):hb + min(bot, 0)])
            if bot > 0:
                parts.append(
                    x.new_full((*x.shape[:2], bot, x.shape[3]), fill)
                    if sp.i == sp.n - 1 else
                    edges[:, :, (sp.i + 1) * 2 * t:
                          (sp.i + 1) * 2 * t + bot])
            x = torch.cat(parts, 2)
        else:
            x = x[:, :, max(-top, 0):hb + min(bot, 0)]
        if self.pool:
            return F.max_pool2d(x, k, s, (0, self.pw))
        return conv_forward(self.inner, x, (0, self.pw))


class _Rescale(nn.Module):
    """A row-local layer that scales the rows (nearest upsampling, pixel
    shuffle): a band's output is the band of the output."""

    def __init__(self, inner, space: Space):
        super().__init__()
        self.inner, self.space = inner, space

    def forward(self, x):
        sp = self.space
        h = sp.height(self, x)
        y = self.inner(x)
        if h is None or sp.splits(h) or not sp.splits(y.shape[2]):
            return y
        return sp.band(y, 2)


class _Whole(nn.Module):
    """A yolo head: the whole map, gathered from the bands."""

    def __init__(self, space: Space):
        super().__init__()
        self.space = space

    def forward(self, x):
        h = self.space.height(self, x)
        if h is None or not self.space.splits(h):
            return x
        return self.space.whole(x, 2)


class _Mean(nn.Module):
    """The SE squeeze: the float32 spatial mean [B, C] of the whole map,
    the bands' sums all-reduced."""

    def __init__(self, space: Space):
        super().__init__()
        self.space = space

    def forward(self, x):
        sp = self.space
        h = sp.height(self, x)
        if h is None or not sp.splits(h):
            return x.float().mean(dim=(2, 3))
        s = coll.all_reduce_sum(x.float().sum(dim=(2, 3)), sp.group)
        return s / (h * x.shape[3])


class SplitNetwork(nn.Module):
    """`model` (wrapped by `split_rows`) on NHWC input whose rows it splits
    over the space; its output is whole on every rank."""

    def __init__(self, model, space: Space, out_rows_dim):
        super().__init__()
        self.model, self.space = model, space
        self.out_rows_dim = out_rows_dim
        self.plans = {}

    def forward(self, x, *args, **kwargs):
        sp = self.space
        key = tuple(x.shape[1:])
        if key not in self.plans:
            sp.plan, sp.planning = {}, True
            try:
                out = self.model(x[:1], *args, **kwargs)
            finally:
                sp.planning = False
            h_out = (None if self.out_rows_dim is None
                     else out.shape[self.out_rows_dim])
            self.plans[key] = (sp.plan, h_out)
        sp.plan, h_out = self.plans[key]
        y = self.model(sp.band(x, 1) if sp.splits(x.shape[1]) else x,
                       *args, **kwargs)
        if h_out is not None and sp.splits(h_out):
            y = sp.whole(y, self.out_rows_dim)
        return y


def _wrap(m, space):
    """m's stand-in on split rows; m itself where it is row-local; None
    where its children decide."""
    if isinstance(m, yolo_mod.Head):
        return _Whole(space)
    if isinstance(m, kpd_mod.Squeeze):
        return _Mean(space)
    if isinstance(m, (nn.Upsample, nn.PixelShuffle)):
        return _Rescale(m, space)
    if isinstance(m, (nn.MaxPool2d, nn.Conv2d, yolo_mod.ConvLayer,
                      ColumnParallel)):
        k, s, *_ = _geometry(m)
        return m if k == 1 and s == 1 else _Window(m, space)
    return None


def split_rows(model: nn.Module, space: Space) -> SplitNetwork:
    """A copy of `model` (a `yolov3.Darknet` or a `kpd.FastPose`, either
    possibly `tensor_parallel`) whose maps' rows are split over `space`."""
    model = copy.deepcopy(model)

    def wrap(parent):
        for name, child in parent.named_children():
            new = _wrap(child, space)
            if new is None:
                wrap(child)
            elif new is not child:
                setattr(parent, name, new)

    wrap(model)
    return SplitNetwork(model, space,
                        2 if isinstance(model, kpd_mod.FastPose) else None)
