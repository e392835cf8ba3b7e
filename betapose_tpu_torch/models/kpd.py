"""KPD, the key-point detector: FastPose (SE-ResNet50/101 + DUC) as an
`nn.Module`.

Counterpart of `betapose_tpu/models/kpd.py` and of the reference
architecture (`KPD/src/models/FastPose.py:13-35`, `layers/SE_Resnet.py`,
`layers/DUC.py`, `layers/SE_module.py`):

  input [B, 320, 256, 3] (NHWC, normalized RGB)
  -> conv7x7/2 + BN + ReLU -> maxpool3x3/2 pad 1       (64,  H/4)
  -> layer1..4 bottlenecks (3, 4, 6|23, 3)             (2048, H/32)
  -> pixel_shuffle(2) -> DUC(512->1024) -> DUC(256->512)
  -> conv3x3 -> heatmaps [B, K, H/4, W/4]

Bottlenecks: 1x1 -> 3x3(stride) -> 1x1(x4), with the SE gate (reduction 1)
only on blocks that carry a downsample projection (`SE_Resnet.py:92-95`).
Batch norm eps is 1e-5.

The module names are the reference `state_dict` names, so the JAX
package's `kpd.torch_state_dict_to_params(model.state_dict())` gives the
JAX params; `params_from_state_dict` is the port's own copy of that
function (numpy only) and `state_dict_from_jax` its inverse.

Training (`train/kpd_train.py`): in train mode each `nn.BatchNorm2d`
normalizes with the batch mean and biased variance and rolls its running
statistics with momentum 0.1 and the unbiased variance, as the JAX
`_bn(train=True)` and `apply_bn_updates` do.  The convs are
`models/precision.Conv2d`, which the train step switches to its
`--trainPrecision` mode.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from betapose_tpu_torch.models import stem_s2d
from betapose_tpu_torch.models.precision import Conv2d
from betapose_tpu_torch.parallel.collectives import (group_size,
                                                     sync_batch_norm)

BN_EPS = 1e-5
RESNET_LAYERS = {"resnet50": [3, 4, 6, 3], "resnet101": [3, 4, 23, 3]}


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (same buffers, same `state_dict` names) that, with
    `group` set to a data-parallel process group of several ranks
    (`parallel/layers.set_batch_norm_group`), normalizes in train mode with
    the mean and biased variance of the global batch and rolls the running
    statistics from them as `nn.BatchNorm2d` does (momentum 0.1, the
    unbiased variance of the global count), so every rank holds the same
    buffers.  Without a group it is `nn.BatchNorm2d`."""

    group = None

    def forward(self, x):
        if not self.training or group_size(self.group) == 1:
            return super().forward(x)
        y, mean, var, n = sync_batch_norm(x, self.weight, self.bias,
                                          self.eps, self.group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / (n - 1)))
            self.num_batches_tracked += 1
        return y


def _bn(c):
    return BatchNorm2d(c, eps=BN_EPS)


class Squeeze(nn.Module):
    """The SE squeeze: the float32 spatial mean [B, C] of NCHW x."""

    def forward(self, x):
        return x.float().mean(dim=(2, 3))


class SELayer(nn.Module):
    """Squeeze-excitation channel gate (`SE_module.py:4-19`, reduction 1).
    The squeeze (a spatial mean) is taken in float32."""

    def __init__(self, channel):
        super().__init__()
        self.squeeze = Squeeze()
        self.fc = nn.Sequential(nn.Linear(channel, channel), nn.ReLU(),
                                nn.Linear(channel, channel), nn.Sigmoid())

    def forward(self, x):
        dtype = next(self.fc.parameters()).dtype
        s = self.squeeze(x).to(dtype)
        return x * self.fc(s)[:, :, None, None].to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride, downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.se = SELayer(planes * 4) if downsample else None
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            _bn(planes * 4)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class SEResnet(nn.Module):
    def __init__(self, arch: str):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for li, (planes, blocks) in enumerate(
                zip([64, 128, 256, 512], RESNET_LAYERS[arch]), start=1):
            stride = 1 if li == 1 else 2
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                layer.append(Bottleneck(
                    inplanes, planes, s, s != 1 or inplanes != planes * 4))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, x, s2d_stem=False):
        if s2d_stem:
            y1 = stem_s2d.fastpose_stem_s2d(self.conv1, x)
        else:
            y1 = self.conv1(x)
        x = self.maxpool(F.relu(self.bn1(y1)))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class DUC(nn.Module):
    """Dense upsampling convolution: conv3x3, BN, ReLU, pixel shuffle."""

    def __init__(self, inplanes, planes):
        super().__init__()
        self.conv = Conv2d(inplanes, planes, 3, padding=1, bias=False)
        self.bn = _bn(planes)
        self.pixel_shuffle = nn.PixelShuffle(2)

    def forward(self, x):
        return self.pixel_shuffle(F.relu(self.bn(self.conv(x))))


class FastPose(nn.Module):
    """forward(x): NHWC crops [B, H, W, 3] -> heatmaps [B, K, H/4, W/4].

    forward(x, s2d_stem=True) computes the 7x7/2 stem conv exactly through
    space-to-depth (`models/stem_s2d.py`), as the JAX `kpd.forward` does
    with `s2d_stem=True`; H and W must then be even."""

    def __init__(self, n_classes: int = 50, arch: str = "resnet101",
                 generator: torch.Generator | None = None):
        super().__init__()
        if arch not in RESNET_LAYERS:
            raise ValueError(f"FastPose arch {arch!r}: resnet50 or resnet101")
        self.arch = arch
        self.n_classes = n_classes
        self.preact = SEResnet(arch)
        self.suffle1 = nn.PixelShuffle(2)
        self.duc1 = DUC(512, 1024)
        self.duc2 = DUC(256, 512)
        self.conv_out = Conv2d(128, n_classes, 3, padding=1)
        init_params(self, generator)
        self.eval()  # built as served; the trainer calls .train()

    def forward(self, x, s2d_stem=False):
        x = self.preact(x.permute(0, 3, 1, 2), s2d_stem)  # NHWC -> NCHW
        x = self.duc2(self.duc1(self.suffle1(x)))
        return self.conv_out(x)


@torch.no_grad()
def init_params(model: FastPose, generator: torch.Generator | None = None):
    """The JAX package's init, drawn from a torch.Generator: He-normal
    convs, identity batch norms, uniform(+-1/sqrt(fan_in)) SE linears and
    output conv."""
    def uniform(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and name != "conv_out":
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * np.sqrt(2.0 / fan_in))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, nn.Linear):
            uniform(m.weight, 1.0 / np.sqrt(m.in_features))
            uniform(m.bias, 1.0 / np.sqrt(m.in_features))
    bound = 1.0 / np.sqrt(128 * 9)
    uniform(model.conv_out.weight, bound)
    uniform(model.conv_out.bias, bound)
    return model


def _conv_bn_pairs(model: FastPose):
    """(parent module, conv attribute, bn attribute) for every conv+BN."""
    pre = model.preact
    pairs = [(pre, "conv1", "bn1")]
    for li in range(1, 5):
        for blk in getattr(pre, f"layer{li}"):
            pairs += [(blk, f"conv{i}", f"bn{i}") for i in (1, 2, 3)]
            if blk.downsample is not None:
                pairs.append((blk.downsample, "0", "1"))
    pairs += [(model.duc1, "conv", "bn"), (model.duc2, "conv", "bn")]
    return pairs


@torch.no_grad()
def fold_bn(model: FastPose) -> FastPose:
    """A copy of `model` with every batch norm folded into its conv: the
    conv gets weight * gamma/sqrt(var+eps) and a bias, the BN becomes the
    identity.  (The JAX `fold_bn` keeps identity BN dicts instead, to keep
    its param tree's shape.)"""
    folded = copy.deepcopy(model)
    for parent, c, b in _conv_bn_pairs(folded):
        conv, bn = getattr(parent, c), getattr(parent, b)
        scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
        new = nn.Conv2d(conv.in_channels, conv.out_channels,
                        conv.kernel_size, conv.stride, conv.padding,
                        bias=True).to(conv.weight)
        new.weight.copy_(conv.weight * scale[:, None, None, None])
        new.bias.copy_(bn.bias - bn.running_mean * scale)
        setattr(parent, c, new)
        setattr(parent, b, nn.Identity())
    return folded


_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
_BN_KEYS = {v: k for k, v in _BN_NAMES.items()}


def _numpy_state(state_dict):
    """(key, float32 numpy array) of a state_dict, 'module.'/'model.'
    prefixes removed and BN step counters skipped."""
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        for pref in ("module.", "model."):
            if key.startswith(pref):
                key = key[len(pref):]
        if hasattr(val, "detach"):
            val = val.detach().cpu().numpy()
        yield key, np.asarray(val, np.float32)


def _as_lists(tree):
    """Dicts whose keys are all ints become lists, in index order."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _as_lists(v) for k, v in tree.items()}
    if tree and all(isinstance(k, int) for k in tree):
        return [tree[i] for i in range(len(tree))]
    return tree


def params_from_state_dict(state_dict) -> dict:
    """The JAX package's `kpd.torch_state_dict_to_params`, with numpy: the
    JAX param tree (nested dicts, lists of blocks, float32 arrays) of a
    FastPose `state_dict`.  OIHW convs become HWIO, [out,in] linears
    [in,out], BN weight/bias/running_mean/running_var scale/bias/mean/var.
    'module.'/'model.' prefixes are removed and `num_batches_tracked`
    skipped; any other key the tree has no place for raises."""
    tree = {}
    for key, v in _numpy_state(state_dict):
        parts = key.split(".")
        if parts[0] == "preact":
            parts = parts[1:]
        if v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        last = parts[-1]
        if parts[0] in ("conv1", "conv_out") and len(parts) == 2:
            path = [parts[0], "w" if last == "weight" else "b"]
        elif parts[0] == "bn1" and len(parts) == 2:
            path = ["bn1", _BN_KEYS[last]]
        elif parts[0].startswith("layer") and len(parts) >= 4:
            blk, sub = [parts[0], int(parts[1])], parts[2]
            if sub.startswith("conv"):
                path = blk + [sub, "w"]
            elif sub.startswith("bn"):
                path = blk + [sub, _BN_KEYS[last]]
            elif sub == "downsample":
                path = blk + (["downsample", "conv", "w"] if parts[3] == "0"
                              else ["downsample", "bn", _BN_KEYS[last]])
            elif sub == "se":
                fc = "fc1" if parts[4] == "0" else "fc2"
                if last == "weight":
                    v = v.T
                path = blk + ["se", fc, "w" if last == "weight" else "b"]
            else:
                raise ValueError(f"FastPose state_dict: unknown key {key!r}")
        elif parts[0] in ("duc1", "duc2") and len(parts) == 3:
            path = ([parts[0], "conv", "w"] if parts[1] == "conv"
                    else [parts[0], "bn", _BN_KEYS[last]])
        else:
            raise ValueError(f"FastPose state_dict: unknown key {key!r}")
        node = tree
        for step in path[:-1]:
            node = node.setdefault(step, {})
        node[path[-1]] = np.ascontiguousarray(v)
    return _as_lists(tree)


def state_dict_from_jax(params) -> dict:
    """The inverse of the JAX package's `kpd.torch_state_dict_to_params`:
    a FastPose `state_dict` (reference names, `preact.` prefix) from the
    JAX param tree.  HWIO convs become OIHW, [in,out] linears [out,in], BN
    scale/bias/mean/var weight/bias/running_mean/running_var."""
    sd = {}

    def put(name, a, transpose=None):
        a = np.asarray(a, dtype=np.float32)
        sd[name] = torch.from_numpy(
            (a.transpose(transpose) if transpose else a).copy())

    def conv(name, p):
        put(name + ".weight", p["w"], (3, 2, 0, 1))

    def bn(name, p):
        for k, v in _BN_NAMES.items():
            put(f"{name}.{v}", p[k])
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    conv("preact.conv1", params["conv1"])
    bn("preact.bn1", params["bn1"])
    for li in range(1, 5):
        for bi, blk in enumerate(params[f"layer{li}"]):
            pre = f"preact.layer{li}.{bi}"
            for i in (1, 2, 3):
                conv(f"{pre}.conv{i}", blk[f"conv{i}"])
                bn(f"{pre}.bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                conv(f"{pre}.downsample.0", blk["downsample"]["conv"])
                bn(f"{pre}.downsample.1", blk["downsample"]["bn"])
            if "se" in blk:
                for fc, idx in (("fc1", 0), ("fc2", 2)):
                    put(f"{pre}.se.fc.{idx}.weight", blk["se"][fc]["w"],
                        (1, 0))
                    put(f"{pre}.se.fc.{idx}.bias", blk["se"][fc]["b"])
    for d in ("duc1", "duc2"):
        conv(f"{d}.conv", params[d]["conv"])
        bn(f"{d}.bn", params[d]["bn"])
    put("conv_out.weight", params["conv_out"]["w"], (3, 2, 0, 1))
    put("conv_out.bias", params["conv_out"]["b"])
    return sd

