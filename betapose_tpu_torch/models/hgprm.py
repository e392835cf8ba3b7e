"""hgPRM, PyraNet: the stacked hourglass of Pyramid Residual Modules, the
alternative KPD backbone (`--netType hgPRM`), as an `nn.Module`.

Counterpart of `betapose_tpu/models/hgprm.py` and of the reference
architecture (`KPD/src/models/hgPRM.py:63-143`, `layers/PRM.py`,
`layers/Residual.py`):

  input [B, H, W, 3] (NHWC, normalized RGB)
  -> conv7x7/2 + BN + ReLU -> PRM(64->128, no preact) + maxpool2
  -> PRM(128->128) -> PRM(128->nFeats)                  (nFeats, H/4)
  -> nStack x [hourglass depth 4 -> BN ReLU conv1x1 BN ReLU -> head
               conv1x1 (K); between stacks the features and the head are
               mapped back and added]
  -> the last head's heatmaps [B, K, H/4, W/4]

PRM residual: a bottleneck branch and a pyramid branch (C scales, each a
max-pool to a fraction 2^(-(i+1)/C) of the size, a conv3x3 and an
align-corners bilinear resize back, summed), merged, then a 1x1 conv; plus
the identity or a BN+ReLU+conv skip.  The reference's stochastic
`FractionalMaxPool2d` is the JAX package's deterministic segment-max
binning (input row i goes to bin (i*out)//in; PARITY.md 2.5), which
`F.adaptive_max_pool2d` does not compute (its windows overlap).

The module names are the reference `state_dict` names, so the JAX
package's `hgprm.torch_state_dict_to_params(model.state_dict())` gives the
JAX params; `params_from_state_dict` is the port's numpy copy of that
function and `state_dict_from_jax` its inverse.  Heatmap sides (H/4, W/4)
must be multiples of 16 (the depth-4 hourglass).

Batch norm: in eval mode it uses the running statistics.  In train mode
it normalizes with the batch's and leaves the running statistics as they
are, as the JAX package trains PyraNet (`hgprm.forward(train=True)`);
`calibrate_bn` writes one batch's statistics into them before
validation, snapshots and serving.  The convs are
`models/precision.Conv2d`, which the train step switches to its
`--trainPrecision` mode.
"""

from __future__ import annotations

import copy
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from betapose_tpu_torch.models.kpd import _BN_NAMES, _numpy_state
from betapose_tpu_torch.models.precision import Conv2d
from betapose_tpu_torch.parallel.collectives import (group_size,
                                                     sync_batch_norm)

BN_EPS = 1e-5


# ---------------------------------------------------------------------------
# primitives (NCHW)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _bin_index(n_in: int, n_out: int, device: torch.device):
    """[n_out, width] input indices of each segment-max bin (bin k holds
    the rows i with (i*n_out)//n_in == k), each bin padded to the widest
    with its own last row, which leaves its max unchanged."""
    if not 1 <= n_out <= n_in:
        raise ValueError(f"segment-max pool from {n_in} to {n_out} bins")
    bins = (np.arange(n_in) * n_out) // n_in
    starts = np.searchsorted(bins, np.arange(n_out), side="left")
    ends = np.searchsorted(bins, np.arange(n_out), side="right")
    width = int((ends - starts).max())
    idx = np.minimum(starts[:, None] + np.arange(width), ends[:, None] - 1)
    with torch.inference_mode(False):
        return torch.as_tensor(idx, device=device)


def _segment_max(x, dim: int, n_out: int):
    idx = _bin_index(x.shape[dim], n_out, x.device)
    g = x.index_select(dim, idx.flatten())
    return g.unflatten(dim, idx.shape).amax(dim + 1)


def adaptive_max_pool(x, out_h: int, out_w: int):
    """Deterministic adaptive max pool by segment-max binning (NCHW): input
    row i goes to bin (i*out_h)//H, column j to (j*out_w)//W (the JAX
    `hgprm.adaptive_max_pool`).  Exact: a max of the bin's values."""
    return _segment_max(_segment_max(x, 2, out_h), 3, out_w)


@functools.lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int, device: torch.device):
    """[n_out, n_in] align-corners linear interpolation weights, computed
    in float32 as the JAX `_bilinear_resize_ac` does."""
    src = (np.arange(n_out, dtype=np.float32)
           * np.float32((n_in - 1) / max(n_out - 1, 1)))
    m = np.clip(np.float32(1.0) - np.abs(
        src[:, None] - np.arange(n_in, dtype=np.float32)[None, :]), 0, None)
    with torch.inference_mode(False):
        return torch.as_tensor(m.astype(np.float32), device=device)


def bilinear_resize_ac(x, out_h: int, out_w: int):
    """align_corners=True bilinear resize (NCHW) as the JAX function's two
    interpolation-matrix products, rows first, in float32 (TF32 is off on
    the card, `core/device.py`)."""
    rows = _interp_matrix(x.shape[2], out_h, x.device).to(x.dtype)
    cols = _interp_matrix(x.shape[3], out_w, x.device).to(x.dtype)
    return torch.matmul(torch.matmul(rows, x), cols.t())


def _conv(cin, cout, k=1, gain=1.0, stride=1, pad=0):
    """A conv with a bias; `gain` scales its xavier init (`init_params`)."""
    conv = Conv2d(cin, cout, k, stride, pad)
    conv.gain = gain
    return conv


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train mode normalizes with the batch mean
    and biased variance and leaves the running statistics untouched (the
    JAX `_bn_train`; torch's momentum=None would average them instead).
    With `group` set to a data-parallel process group of several ranks
    (`parallel/layers.set_batch_norm_group`), the mean and variance are
    those of the global batch, every rank's rows."""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if group_size(self.group) > 1:
            return sync_batch_norm(x, self.weight, self.bias, self.eps,
                                   self.group)[0]
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


def _bn(c):
    return BatchNorm2d(c, eps=BN_EPS)


def _bn_relu(c):
    return [_bn(c), nn.ReLU()]


class ConcatTable(nn.Module):
    """The reference's ConcatTable followed by its CaddTable: every branch
    of `modules_list` runs on the input and the outputs are summed, in
    order."""

    def __init__(self, branches):
        super().__init__()
        self.modules_list = nn.ModuleList(branches)

    def forward(self, x):
        out = self.modules_list[0](x)
        for m in self.modules_list[1:]:
            out = out + m(x)
        return out


class PyramidScale(nn.Sequential):
    """One scale of the pyramid branch: segment-max pool to
    max(1, int(ratio*H)) x max(1, int(ratio*W)), conv3x3 (index 1, the
    reference's name), align-corners bilinear resize back to H x W."""

    def __init__(self, ratio: float, d: int):
        super().__init__(nn.Identity(), _conv(d, d, 3, pad=1))
        self.ratio = ratio

    def forward(self, x):
        h, w = x.shape[2:]
        s = adaptive_max_pool(x, max(1, int(self.ratio * h)),
                              max(1, int(self.ratio * w)))
        return bilinear_resize_ac(self[1](s), h, w)


class Skip(nn.Module):
    """The PRM skip layer: the identity, or BN+ReLU+conv1x1 as `m` when the
    channels change or `use_conv` asks for it."""

    def __init__(self, cin, cout, use_conv):
        super().__init__()
        self.m = (nn.Sequential(*_bn_relu(cin), _conv(cin, cout, 1,
                                                      math.sqrt(1 / 2)))
                  if cin != cout or use_conv else None)

    def forward(self, x):
        return x if self.m is None else self.m(x)


class PRMResidual(nn.Module):
    """The PRM residual (`layers/PRM.py`; JAX `prm_residual`).  With
    preact=False (the first one, 'no_preact') the branches take the input
    without their leading BN+ReLU."""

    def __init__(self, cin, cout, preact=True, use_conv=False,
                 base_width=9, cardinality=5):
        super().__init__()
        d = max(1, cout // base_width)
        half = cout // 2
        c = cardinality

        def pre():
            return _bn_relu(cin) if preact else []

        bottleneck = nn.Sequential(
            *pre(), _conv(cin, half, 1, math.sqrt(1 / 2)), *_bn_relu(half),
            _conv(half, half, 3, pad=1))
        sc = 2 ** (1 / c)
        pyramid = nn.Sequential(
            *pre(), _conv(cin, d, 1, math.sqrt(1 / c)), *_bn_relu(d),
            nn.Sequential(ConcatTable([PyramidScale(1 / sc ** (i + 1), d)
                                       for i in range(c)])),
            *_bn_relu(d), _conv(d, half, 1, math.sqrt(1 / c)))
        block = nn.Sequential(
            nn.Sequential(ConcatTable([bottleneck, pyramid])),
            *_bn_relu(half), _conv(half, cout, 1, math.sqrt(1 / 2)))
        self.con = ConcatTable([block, Skip(cin, cout, use_conv)])

    def forward(self, x):
        return self.con(x)


class PlainResidual(nn.Sequential):
    """The plain pre-activation residual (`layers/Residual.py`; JAX
    `plain_residual`): BN ReLU conv1x1, BN ReLU conv3x3, BN ReLU conv1x1,
    plus the identity or a BN+ReLU+conv skip."""

    def __init__(self, cin, cout, use_conv=False):
        half = cout // 2
        block = nn.Sequential(
            *_bn_relu(cin), _conv(cin, half, 1, math.sqrt(1 / 2)),
            *_bn_relu(half), _conv(half, half, 3, pad=1),
            *_bn_relu(half), _conv(half, cout, 1))
        skip = (nn.Sequential(*_bn_relu(cin),
                              _conv(cin, cout, 1, math.sqrt(1 / 2)))
                if cin != cout or use_conv else nn.Identity())
        super().__init__(ConcatTable([block, skip]))


class Hourglass(nn.Module):
    """Depth-n hourglass (`hgPRM.py:10-61`): PRM residuals in the upper
    branch at n >= 2 and in the lower branch at n >= 3, plain ones
    elsewhere; the lower branch is maxpool2 -> residuals -> the depth n-1
    hourglass (residuals at n = 1) -> residuals with a conv skip (useConv)
    -> nearest 2x upsample."""

    def __init__(self, n, n_feats, n_modules, base_width, cardinality):
        super().__init__()

        def residuals(use_pyra, use_conv=False):
            return nn.Sequential(*[
                PRMResidual(n_feats, n_feats, use_conv=use_conv,
                            base_width=base_width, cardinality=cardinality)
                if use_pyra else PlainResidual(n_feats, n_feats, use_conv)
                for _ in range(n_modules)])

        self.upperBranch = residuals(n >= 2)
        inner = (Hourglass(n - 1, n_feats, n_modules, base_width,
                           cardinality) if n > 1 else residuals(n >= 3))
        self.lowerBranch = nn.Sequential(
            nn.Sequential(nn.MaxPool2d(2, 2), residuals(n >= 3)),
            inner,
            residuals(n >= 3, use_conv=True),
            nn.Upsample(scale_factor=2, mode="nearest"))

    def forward(self, x):
        return self.upperBranch(x) + self.lowerBranch(x)


class PyraNet(nn.Module):
    """forward(x): NHWC crops [B, H, W, 3] -> the last head's heatmaps
    [B, K, H/4, W/4] (PyraNet_Inference); all_heads=True returns the
    nStack heads in a list (PyraNet).  Defaults are `opt.py`'s."""

    def __init__(self, n_classes: int = 50, n_feats: int = 256,
                 n_stack: int = 4, n_residual: int = 1, base_width: int = 9,
                 cardinality: int = 5,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_classes = n_classes
        self.n_stack = n_stack
        self.n_residual = n_residual
        self.cardinality = cardinality
        kw = dict(base_width=base_width, cardinality=cardinality)
        self.preact = nn.Sequential(
            nn.Sequential(_conv(3, 64, 7, math.sqrt(1 / 3), 2, 3),
                          *_bn_relu(64)),
            nn.Sequential(PRMResidual(64, 128, preact=False, **kw),
                          nn.MaxPool2d(2, 2)),
            PRMResidual(128, 128, **kw),
            PRMResidual(128, n_feats, **kw))
        self.stack_lin = nn.ModuleList(nn.Sequential(
            Hourglass(4, n_feats, n_residual, base_width, cardinality),
            *_bn_relu(n_feats), _conv(n_feats, n_feats, 1, math.sqrt(1 / 2)),
            *_bn_relu(n_feats)) for _ in range(n_stack))
        self.stack_out = nn.ModuleList(
            _conv(n_feats, n_classes) for _ in range(n_stack))
        self.stack_lin_ = nn.ModuleList(
            _conv(n_feats, n_feats) for _ in range(n_stack - 1))
        self.stack_out_ = nn.ModuleList(
            _conv(n_classes, n_feats) for _ in range(n_stack - 1))
        init_params(self, generator)
        self.eval()  # built as served; the trainer calls .train()

    def forward(self, x, all_heads: bool = False):
        inter = self.preact(x.permute(0, 3, 1, 2))        # NHWC -> NCHW
        outs = []
        for i in range(self.n_stack):
            lin = self.stack_lin[i](inter)
            outs.append(self.stack_out[i](lin))
            if i < self.n_stack - 1:
                inter = (inter + self.stack_lin_[i](lin)
                         + self.stack_out_[i](outs[-1]))
        return outs if all_heads else outs[-1]


@torch.no_grad()
def init_params(model: PyraNet, generator: torch.Generator | None = None):
    """The JAX package's init, drawn from a torch.Generator: xavier-normal
    convs, std = gain * sqrt(2 / (fan_in + fan_out)) with each conv's gain
    (`hgprm.py:133-136`), zero biases, identity batch norms."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            std = m.gain * math.sqrt(
                2.0 / (m.in_channels * k + m.out_channels * k))
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * std)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


@torch.no_grad()
def calibrate_bn(model: PyraNet, x, momentum: float = 1.0) -> PyraNet:
    """Post-hoc BN calibration (the JAX `hgprm.calibrate_bn`): one forward
    of the NHWC batch x with every batch norm normalizing by the batch's
    own mean and biased variance, which are then written into its running
    statistics, new = (1 - momentum) * old + momentum * batch.  Returns a
    new module; `model` is left as it is."""
    model = copy.deepcopy(model)
    stats = []

    def batch_norm(bn, inputs, _):
        xf = inputs[0].float()
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
        stats.append((bn, mean, var))
        y = ((xf - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
             * bn.weight[:, None, None] + bn.bias[:, None, None])
        return y.to(inputs[0].dtype)

    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    hooks = [bn.register_forward_hook(batch_norm) for bn in bns]
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    for bn, mean, var in stats:
        bn.running_mean.copy_((1 - momentum) * bn.running_mean
                              + momentum * mean)
        bn.running_var.copy_((1 - momentum) * bn.running_var
                             + momentum * var)
    return model


def state_dict_from_jax(params) -> dict:
    """The inverse of the JAX package's `hgprm.torch_state_dict_to_params`:
    a PyraNet `state_dict` (reference names) from the JAX param tree,
    given as nested dicts and lists of arrays.  The tree's `Static` nodes
    are not read (an `.npz` checkpoint has none): which residuals are PRM
    or plain, preact or not, and which carry a skip conv follows from the
    keys present.  HWIO convs become OIHW."""
    sd = {}

    def put(name, a, transpose=None):
        a = np.asarray(a, dtype=np.float32)
        sd[name] = torch.from_numpy(
            (a.transpose(transpose) if transpose else a).copy())

    def conv(name, p):
        put(name + ".weight", p["w"], (3, 2, 0, 1))
        put(name + ".bias", p["b"])

    def bn(name, p):
        for k, v in _BN_NAMES.items():
            put(f"{name}.{v}", p[k])
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    def skip(prefix, p):
        if "skip_conv" in p:
            bn(f"{prefix}.0", p["skip_bn"])
            conv(f"{prefix}.2", p["skip_conv"])

    def prm(prefix, p):
        cb = prefix + ".con.modules_list.0"
        b1, b2 = cb + ".0.0.modules_list.0", cb + ".0.0.modules_list.1"
        off = 2 if "pre1" in p else 0
        if off:
            bn(f"{b1}.0", p["pre1"])
            bn(f"{b2}.0", p["pre2"])
        conv(f"{b1}.{off}", p["b1_conv1"])
        bn(f"{b1}.{off + 1}", p["b1_bn"])
        conv(f"{b1}.{off + 3}", p["b1_conv2"])
        conv(f"{b2}.{off}", p["b2_conv1"])
        bn(f"{b2}.{off + 1}", p["b2_bn1"])
        for j, c in enumerate(p["pyra"]):
            conv(f"{b2}.{off + 3}.0.modules_list.{j}.1", c)
        bn(f"{b2}.{off + 4}", p["b2_bn2"])
        conv(f"{b2}.{off + 6}", p["b2_conv2"])
        bn(cb + ".1", p["m_bn"])
        conv(cb + ".3", p["m_conv"])
        skip(prefix + ".con.modules_list.1.m", p)

    def plain(prefix, p):
        cb = prefix + ".0.modules_list.0"
        bn(f"{cb}.0", p["pre"])
        for i, name in ((2, "conv1"), (5, "conv2"), (8, "conv3")):
            conv(f"{cb}.{i}", p[name])
        bn(f"{cb}.3", p["bn1"])
        bn(f"{cb}.6", p["bn2"])
        skip(prefix + ".0.modules_list.1", p)

    def residuals(prefix, ps):
        for m, p in enumerate(ps):
            (prm if "b1_conv1" in p else plain)(f"{prefix}.{m}", p)

    def hourglass(prefix, p):
        residuals(f"{prefix}.upperBranch", p["up1"])
        residuals(f"{prefix}.lowerBranch.0.1", p["low1"])
        if "low2" in p:
            hourglass(f"{prefix}.lowerBranch.1", p["low2"])
        else:
            residuals(f"{prefix}.lowerBranch.1", p["low2_res"])
        residuals(f"{prefix}.lowerBranch.2", p["low3"])

    conv("preact.0.0", params["conv1"])
    bn("preact.0.1", params["bn1"])
    prm("preact.1.0", params["r1"])
    prm("preact.2", params["r4"])
    prm("preact.3", params["r5"])
    for i, st in enumerate(params["stacks"]):
        hourglass(f"stack_lin.{i}.0", st["hg"])
        bn(f"stack_lin.{i}.1", st["lin_bn1"])
        conv(f"stack_lin.{i}.3", st["lin_conv"])
        bn(f"stack_lin.{i}.4", st["lin_bn2"])
        conv(f"stack_out.{i}", st["out_conv"])
        if "lin_" in st:
            conv(f"stack_lin_.{i}", st["lin_"])
            conv(f"stack_out_.{i}", st["out_"])
    return sd


def params_from_state_dict(sd, n_stack: int = 4, n_residual: int = 1,
                           cardinality: int = 5):
    """The JAX package's `hgprm.torch_state_dict_to_params`, with numpy:
    the JAX param tree (nested dicts and lists of float32 arrays) of a
    PyraNet `state_dict`, without the tree's `Static` nodes, which hold no
    arrays (a `.npz` checkpoint has none).  Every entry must be consumed:
    leftovers raise."""
    sd = dict(_numpy_state(sd))
    used = set()

    def t(name):
        used.add(name)
        return sd[name]

    def conv(prefix):
        w = t(prefix + ".weight").transpose(2, 3, 1, 0)   # OIHW -> HWIO
        return {"w": np.ascontiguousarray(w), "b": t(prefix + ".bias")}

    def bn(prefix):
        return {k: t(f"{prefix}.{v}") for k, v in _BN_NAMES.items()}

    def prm(prefix, preact=True):
        cb = prefix + ".con.modules_list.0"
        b1 = cb + ".0.0.modules_list.0"
        b2 = cb + ".0.0.modules_list.1"
        off = 2 if preact else 0
        p = {}
        if preact:
            p["pre1"] = bn(f"{b1}.0")
            p["pre2"] = bn(f"{b2}.0")
        p["b1_conv1"] = conv(f"{b1}.{off}")
        p["b1_bn"] = bn(f"{b1}.{off + 1}")
        p["b1_conv2"] = conv(f"{b1}.{off + 3}")
        p["b2_conv1"] = conv(f"{b2}.{off}")
        p["b2_bn1"] = bn(f"{b2}.{off + 1}")
        pyr = f"{b2}.{off + 3}.0.modules_list"
        p["pyra"] = [conv(f"{pyr}.{j}.1") for j in range(cardinality)]
        p["b2_bn2"] = bn(f"{b2}.{off + 4}")
        p["b2_conv2"] = conv(f"{b2}.{off + 6}")
        p["m_bn"] = bn(cb + ".1")
        p["m_conv"] = conv(cb + ".3")
        sk = prefix + ".con.modules_list.1"
        if f"{sk}.m.2.weight" in sd:
            p["skip_bn"] = bn(f"{sk}.m.0")
            p["skip_conv"] = conv(f"{sk}.m.2")
        return p

    def plain(prefix):
        cb = prefix + ".0.modules_list.0"
        p = {"pre": bn(f"{cb}.0"), "conv1": conv(f"{cb}.2"),
             "bn1": bn(f"{cb}.3"), "conv2": conv(f"{cb}.5"),
             "bn2": bn(f"{cb}.6"), "conv3": conv(f"{cb}.8")}
        sk = prefix + ".0.modules_list.1"
        if f"{sk}.2.weight" in sd:
            p["skip_bn"] = bn(f"{sk}.0")
            p["skip_conv"] = conv(f"{sk}.2")
        return p

    def residuals(prefix, use_pyra):
        return [(prm if use_pyra else plain)(f"{prefix}.{m}")
                for m in range(n_residual)]

    def hg(prefix, n):
        p = {"up1": residuals(f"{prefix}.upperBranch", n >= 2),
             "low1": residuals(f"{prefix}.lowerBranch.0.1", n >= 3),
             "low3": residuals(f"{prefix}.lowerBranch.2", n >= 3)}
        if n > 1:
            p["low2"] = hg(f"{prefix}.lowerBranch.1", n - 1)
        else:
            p["low2_res"] = residuals(f"{prefix}.lowerBranch.1", n >= 3)
        return p

    params = {"conv1": conv("preact.0.0"), "bn1": bn("preact.0.1"),
              "r1": prm("preact.1.0", preact=False), "r4": prm("preact.2"),
              "r5": prm("preact.3"), "stacks": []}
    for i in range(n_stack):
        st = {"hg": hg(f"stack_lin.{i}.0", 4),
              "lin_bn1": bn(f"stack_lin.{i}.1"),
              "lin_conv": conv(f"stack_lin.{i}.3"),
              "lin_bn2": bn(f"stack_lin.{i}.4"),
              "out_conv": conv(f"stack_out.{i}")}
        if i < n_stack - 1:
            st["lin_"] = conv(f"stack_lin_.{i}")
            st["out_"] = conv(f"stack_out_.{i}")
        params["stacks"].append(st)
    leftovers = set(sd) - used
    if leftovers:
        raise ValueError(
            f"unconsumed PyraNet state_dict entries ({len(leftovers)}): "
            f"{sorted(leftovers)[:8]}...")
    return params
