"""YOLOv3 built from a darknet .cfg, as an `nn.Module`.

Counterpart of `betapose_tpu/models/yolov3.py` for the v3 layer subset that
YOLOv3 uses: convolutional (with optional batch norm, leaky or linear
activation), shortcut, route, upsample and yolo.  Any other block type
raises `NotImplementedError`: the rest of the darknet layer zoo waits for
ROADMAP slice 5.

- The public layout is the JAX package's: `Darknet.forward` takes NHWC
  frames [B, reso, reso, 3] and returns decoded detections
  [B, nBoxes, 5+nC].  Inside, the network runs NCHW (a `channels_last`
  memory format on the card).
- Detection decode matches `yolo/darknet.py:129-169`: bx = sigma(tx)+cx,
  by = sigma(ty)+cy, bw = pw*exp(tw), bh = ph*exp(th), scaled by stride;
  sigmoid objectness and classes; rows anchor-major, then grid row, then
  grid column; heads concatenated in cfg order.  Decode runs in float32.
- Weights IO speaks the darknet .weights byte format exactly (reference
  `yolo/darknet.py:365-432`, writer `train_YOLO/src/parser.c:962-1019`):
  int32 header [major, minor, revision] then `seen` (uint64 when
  major*10+minor >= 2, else int32), then a float32 stream with, per conv
  layer, [bn_bias, bn_scale, bn_mean, bn_var] or [conv_bias], then the
  weights in OIHW order (torch's own layout).
- `params_from_jax` loads the JAX package's per-layer param list (numpy,
  HWIO weights) into the module: the bridge the tests use.
- The parameters stay float32 and the network runs in its input's dtype.
  A bf16 input gets the JAX `_conv_layer`'s numerics in every layer: bf16
  weights, float32 sums, bias and activation, one rounding to bf16
  (`conv_bf16`).
- Built in eval mode, as served.  In train mode (`train/yolo_train.py`)
  the batch norms take darknet's training semantics (`BatchNorm2d`), and
  the convs are `models/precision.Conv2d`, so `conv_precision` sets their
  train precision.  `params_to_jax` is the inverse of `params_from_jax`.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from betapose_tpu_torch.models.darknet_cfg import parse_cfg
from betapose_tpu_torch.models.precision import Conv2d
from betapose_tpu_torch.parallel.collectives import (group_size,
                                                     sync_batch_norm)

BN_EPS = 1e-5  # torch BatchNorm2d default, matches reference inference
BN_ROLLING_MOMENTUM = 0.01  # darknet: rolling = .99*rolling + .01*batch
LEAKY_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                   # conv | shortcut | route | upsample | yolo
    out_channels: int
    size: int = 0
    stride: int = 0
    pad: int = 0
    batch_normalize: bool = False
    activation: str = "linear"
    in_channels: int = 0
    from_idx: int = -1          # absolute layer index (shortcut)
    route_idxs: tuple = ()      # absolute layer indices (route)
    anchors: tuple = ()         # ((w,h),...) for this head (mask applied)
    num_classes: int = 0
    ignore_thresh: float = 0.7  # yolo: no objectness loss above this IoU
    focal_loss: bool = False    # yolo: darknet's focal class deltas


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    layers: tuple               # tuple[LayerSpec]
    cache_idxs: frozenset       # layer outputs needed later
    net_info: dict              # [net] block options (may be empty)

    @property
    def yolo_idxs(self):
        return tuple(i for i, l in enumerate(self.layers) if l.kind == "yolo")


_CFG_ALIASES = {"conv": "convolutional", "network": "net"}


def build_spec(cfg) -> NetworkSpec:
    """cfg: path or cfg text.  Returns the static network spec."""
    blocks = [dict(b, type=_CFG_ALIASES.get(b["type"], b["type"]))
              for b in parse_cfg(cfg)]
    net_info = {}
    if blocks and blocks[0]["type"] == "net":
        net_info = blocks[0]
        blocks = blocks[1:]
    out_channels = [int(net_info.get("channels", 3))]
    layers, needed = [], set()
    for i, b in enumerate(blocks):
        t = b["type"]
        cin = out_channels[-1]
        if t == "convolutional":
            size = int(b["size"])
            layers.append(LayerSpec(
                "conv", int(b["filters"]), size=size, stride=int(b["stride"]),
                pad=(size - 1) // 2 if int(b.get("pad", 0)) else 0,
                batch_normalize=int(b.get("batch_normalize", 0)) != 0,
                activation=b.get("activation", "linear"), in_channels=cin))
            if layers[-1].activation not in ("leaky", "linear"):
                raise NotImplementedError(
                    f"activation {layers[-1].activation!r}: the port runs "
                    "leaky and linear only (other darknet activations are "
                    "ROADMAP slice 5)")
        elif t == "shortcut":
            frm = int(b["from"])
            abs_from = i + frm if frm < 0 else frm
            needed.update((abs_from, i - 1))
            layers.append(LayerSpec("shortcut", cin, from_idx=abs_from))
        elif t == "route":
            idxs = [int(x) for x in str(b["layers"]).split(",")]
            abs_idxs = tuple(i + x if x < 0 else x for x in idxs)
            needed.update(abs_idxs)
            layers.append(LayerSpec(
                "route", sum(out_channels[a + 1] for a in abs_idxs),
                route_idxs=abs_idxs))
        elif t == "upsample":
            layers.append(LayerSpec("upsample", cin, stride=int(b["stride"])))
        elif t == "yolo":
            mask = [int(x) for x in b["mask"].split(",")]
            flat = [int(float(x))
                    for x in b["anchors"].replace(" ", "").split(",")]
            pairs = [(flat[j], flat[j + 1]) for j in range(0, len(flat), 2)]
            needed.add(i - 1)  # the head passes its input through
            layers.append(LayerSpec(
                "yolo", cin, anchors=tuple(pairs[m] for m in mask),
                num_classes=int(b["classes"]),
                ignore_thresh=float(b.get("ignore_thresh", 0.7)),
                focal_loss=int(b.get("focal_loss", 0)) != 0))
        elif t in ("region", "detection"):
            raise NotImplementedError(
                f"darknet block [{t}]: the YOLOv1/v2 heads and their "
                "losses are not ported yet (ROADMAP slice 5, the "
                "remainder of Queue 1 item 4)")
        else:
            raise NotImplementedError(
                f"darknet block [{t}]: the port builds convolutional, "
                "shortcut, route, upsample and yolo only (the other layer "
                "kinds are ROADMAP slice 5)")
        out_channels.append(layers[-1].out_channels)
    return NetworkSpec(tuple(layers), frozenset(needed), net_info)


def cached(owner, attr, sources, build):
    """build()'s result, kept on `owner` as `attr` until one of the
    `sources` tensors is replaced or written in place (a moved or reloaded
    network builds it again).  Tensors made under `torch.inference_mode`
    keep no version counter: for those only a replacement is seen."""
    token = tuple((t.data_ptr(), -1 if t.is_inference() else t._version,
                   t.dtype, t.device) for t in sources)
    hit = getattr(owner, attr, None)
    if hit is None or hit[0] != token:
        with torch.no_grad():
            hit = (token, build())
        setattr(owner, attr, hit)
    return hit[1]


def bf16_values(w):
    """w rounded to bfloat16 (the JAX `w.astype(bfloat16)`), held in
    float32, cached on w's owner by the caller."""
    return w.detach().to(torch.bfloat16).float()


@contextlib.contextmanager
def _tf32_convs():
    """Let cuDNN run float32 convolutions on TF32 tensor cores inside the
    block (the port pins TF32 off everywhere else, `core/device.py`).

    This is how a bf16 conv with float32 sums is had in PyTorch, whose bf16
    convs round their output to bf16: a bf16 value is exact in TF32 (7
    against 10 mantissa bits), so the float32 conv of bf16-valued operands
    forms exact products and sums them in float32, the arithmetic of the
    JAX `preferred_element_type=float32`."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv_bf16(x, w32, bias, stride=1, padding=0, activation="linear",
              bn=None):
    """The JAX `_conv_layer` on bf16 `x`: the conv of x and the bf16-valued
    float32 weight `w32` with float32 sums, the float32 bias or batch norm
    `bn`, the activation in float32, and one rounding to bf16 at the
    end."""
    with _tf32_convs():
        y = F.conv2d(x.float(), w32, None if bias is None else bias.float(),
                     stride, padding)
    if bn is not None:
        y = bn(y)
    if activation == "leaky":
        y = F.leaky_relu(y, LEAKY_SLOPE)
    return y.to(torch.bfloat16)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train mode is darknet's (the JAX
    `_conv_layer` with train=True and `apply_bn_updates`): normalize with
    the batch mean and the biased batch variance over (N, H, W), and roll
    the running statistics as 0.99 * old + 0.01 * batch, the variance
    biased too.  (`nn.BatchNorm2d` rolls with momentum 0.1 and the
    unbiased variance.)  Eval mode is `nn.BatchNorm2d`'s.

    With `group` set to a data-parallel process group of several ranks
    (`parallel/layers.set_batch_norm_group`), the statistics are those of
    the global batch, every rank's rows, as GSPMD computes them in the
    JAX step, and every rank rolls the same running statistics."""

    group = None

    def __init__(self, c):
        super().__init__(c, eps=BN_EPS, momentum=BN_ROLLING_MOMENTUM)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if group_size(self.group) > 1:
            y, mean, var, _ = sync_batch_norm(x, self.weight, self.bias,
                                              self.eps, self.group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
        # training=True normalizes by the batch mean and biased variance;
        # with momentum 0 it leaves the running statistics as they are
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


class ConvLayer(nn.Module):
    """darknet [convolutional]: conv, batch norm or bias, activation.

    A bf16 input runs the JAX package's numerics (`conv_bf16`): the layer's
    parameters stay float32 and its weight is rounded to bf16 once, cached
    (`bf16_values`); the output is bf16, rounded once.  A float32 input
    runs the float32 layer."""

    def __init__(self, l: LayerSpec):
        super().__init__()
        self.activation = l.activation
        self.conv = Conv2d(l.in_channels, l.out_channels, l.size,
                           l.stride, l.pad, bias=not l.batch_normalize)
        self.bn = BatchNorm2d(l.out_channels) if l.batch_normalize else None

    def fold(self):
        """Fold the batch norm into the conv weight and a conv bias."""
        if self.bn is None:
            return
        bn, conv = self.bn, self.conv
        scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
        folded = nn.Conv2d(conv.in_channels, conv.out_channels,
                           conv.kernel_size, conv.stride, conv.padding,
                           bias=True).to(conv.weight)
        with torch.no_grad():
            folded.weight.copy_(conv.weight * scale[:, None, None, None])
            folded.bias.copy_(bn.bias - bn.running_mean * scale)
        self.conv, self.bn = folded, None

    def forward(self, x, padding=None):
        """`padding`, when given, replaces the conv's (a spatially split
        map brings its own halo rows, `parallel/spatial.py`)."""
        if x.dtype == torch.bfloat16:
            return self._forward_bf16(x, padding)
        conv = self.conv
        y = (conv(x) if padding is None else
             F.conv2d(x, conv.weight, conv.bias, conv.stride, padding))
        if self.bn is not None:
            y = self.bn(y)
        if self.activation == "leaky":
            y = F.leaky_relu(y, LEAKY_SLOPE)
        return y

    def _forward_bf16(self, x, padding=None):
        conv = self.conv
        w32 = cached(self, "_w_bf16", (conv.weight,),
                     lambda: bf16_values(conv.weight))
        return conv_bf16(x, w32, conv.bias, conv.stride,
                         conv.padding if padding is None else padding,
                         self.activation, self.bn)


def decode_head(x_nhwc, anchors, num_classes, reso):
    """Decode one yolo head's raw output [B, gs, gs, nA*(5+nC)] to
    [B, nA*gs*gs, 5+nC]: (cx, cy, w, h) in input pixels, sigmoid(obj),
    sigmoid(class...).  Rows: anchor-major, then grid row, grid col."""
    b, gs, _, _ = x_nhwc.shape
    na = len(anchors)
    attrs = 5 + num_classes
    stride = reso // gs
    x = x_nhwc.reshape(b, gs, gs, na, attrs).permute(0, 3, 1, 2, 4).float()
    grid = torch.arange(gs, dtype=torch.float32, device=x.device)
    cx = grid[None, None, None, :]
    cy = grid[None, None, :, None]
    anc = torch.tensor(anchors, dtype=torch.float32, device=x.device) / stride
    aw = anc[:, 0][None, :, None, None]
    ah = anc[:, 1][None, :, None, None]
    out = torch.cat([
        ((torch.sigmoid(x[..., 0]) + cx) * stride)[..., None],
        ((torch.sigmoid(x[..., 1]) + cy) * stride)[..., None],
        (torch.exp(x[..., 2]) * aw * stride)[..., None],
        (torch.exp(x[..., 3]) * ah * stride)[..., None],
        torch.sigmoid(x[..., 4:])], dim=-1)
    return out.reshape(b, na * gs * gs, attrs)


class Head(nn.Identity):
    """A [yolo] layer's module: the identity on the head's raw NCHW map
    (a spatial split gathers the map whole here, `parallel/spatial.py`)."""


def _layer_module(l: LayerSpec) -> nn.Module:
    if l.kind == "conv":
        return ConvLayer(l)
    if l.kind == "upsample":
        return nn.Upsample(scale_factor=l.stride, mode="nearest")
    return Head() if l.kind == "yolo" else nn.Identity()


class Darknet(nn.Module):
    """The network of a `NetworkSpec`; the reference's `Darknet(cfg, reso)`
    (`yolo/darknet.py:319-363`).  `forward(x)` takes NHWC [B, reso, reso,
    3] and returns the decoded detections [B, nBoxes, 5+nC] in float32."""

    def __init__(self, spec: NetworkSpec, reso: int = 416,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.reso = int(reso)
        self.layers = nn.ModuleList(_layer_module(l) for l in spec.layers)
        init_params(self, generator)
        self.eval()  # built as served; the trainer calls .train()

    def forward(self, x, decode=True):
        """decode=False returns the raw heads, NHWC [B, gs, gs, nA*(5+nC)]
        each, as the JAX `forward(..., decode=False)` does."""
        return self.run_layers(x.permute(0, 3, 1, 2), 0, {}, decode)

    def run_layers(self, x, start, cache, decode=True):
        """Layers `start`.. on the NCHW activation x, with `cache` holding
        the outputs of earlier layers that later ones read (the s2d stem
        enters at layer 2)."""
        decoded = []
        for i, (l, mod) in enumerate(zip(self.spec.layers, self.layers)):
            if i < start:
                continue
            if l.kind == "conv":
                x = mod(x)
            elif l.kind == "shortcut":
                x = cache[i - 1] + cache[l.from_idx]
            elif l.kind == "route":
                x = (cache[l.route_idxs[0]] if len(l.route_idxs) == 1 else
                     torch.cat([cache[a] for a in l.route_idxs], dim=1))
            elif l.kind == "upsample":
                x = mod(x)
            elif l.kind == "yolo":
                head = mod(x).permute(0, 2, 3, 1)
                decoded.append(decode_head(head, l.anchors, l.num_classes,
                                           self.reso) if decode else head)
                x = cache[i - 1]
            if i in self.spec.cache_idxs:
                cache[i] = x
        return torch.cat(decoded, dim=1) if decode else decoded


def conv_layers(model: Darknet):
    return [(l, m) for l, m in zip(model.spec.layers, model.layers)
            if l.kind == "conv"]


@torch.no_grad()
def init_params(model: Darknet, generator: torch.Generator | None = None):
    """He-normal conv weights (std sqrt(2/fan_in)), zero biases, identity
    batch norm: the JAX package's init, drawn from a torch.Generator."""
    for l, m in conv_layers(model):
        w = torch.randn(m.conv.weight.shape, generator=generator,
                        dtype=torch.float32)
        m.conv.weight.copy_(w * np.sqrt(2.0 / (l.in_channels * l.size ** 2)))
        if m.conv.bias is not None:
            m.conv.bias.zero_()
        if m.bn is not None:
            m.bn.reset_parameters()
    return model


def fold_bn(model: Darknet) -> Darknet:
    """A copy of `model` with every batch norm folded into its conv."""
    folded = copy.deepcopy(model)
    for _, m in conv_layers(folded):
        m.fold()
    return folded


def _np(a):
    return np.array(a, dtype=np.float32)


@torch.no_grad()
def params_from_jax(spec: NetworkSpec, layers, reso: int = 416) -> Darknet:
    """A Darknet holding the JAX package's per-layer params (numpy or
    arrays): conv {"w" HWIO, "b"} or {"w", "bn_scale", "bn_bias",
    "bn_mean", "bn_var"}.  A batch-norm layer given as {"w", "b"} (the
    output of the JAX `fold_bn`) becomes a folded layer here."""
    model = Darknet(spec, reso)
    for (l, m), p in zip(conv_layers(model),
                         [p for l, p in zip(spec.layers, layers)
                          if l.kind == "conv"]):
        if m.bn is not None and "bn_scale" not in p:
            m.fold()
        m.conv.weight.copy_(torch.from_numpy(
            _np(p["w"]).transpose(3, 2, 0, 1).copy()))
        if m.bn is None:
            m.conv.bias.copy_(torch.from_numpy(_np(p["b"])))
        else:
            m.bn.weight.copy_(torch.from_numpy(_np(p["bn_scale"])))
            m.bn.bias.copy_(torch.from_numpy(_np(p["bn_bias"])))
            m.bn.running_mean.copy_(torch.from_numpy(_np(p["bn_mean"])))
            m.bn.running_var.copy_(torch.from_numpy(_np(p["bn_var"])))
    return model


def params_to_jax(model: Darknet):
    """The inverse of `params_from_jax`: the JAX package's per-layer param
    list as numpy float32, conv {"w" HWIO, "b"} or {"w", "bn_scale",
    "bn_bias", "bn_mean", "bn_var"}, and {} for a layer without
    parameters."""
    def a(t):
        return t.detach().float().cpu().numpy()

    out = []
    for l, m in zip(model.spec.layers, model.layers):
        if l.kind != "conv":
            out.append({})
            continue
        p = {"w": a(m.conv.weight).transpose(2, 3, 1, 0)}
        if m.bn is None:
            p["b"] = a(m.conv.bias)
        else:
            p.update(bn_scale=a(m.bn.weight), bn_bias=a(m.bn.bias),
                     bn_mean=a(m.bn.running_mean),
                     bn_var=a(m.bn.running_var))
        out.append(p)
    return out


@torch.no_grad()
def load_darknet_weights(spec: NetworkSpec, path, reso: int = 416,
                         allow_partial: bool = True,
                         generator: torch.Generator | None = None):
    """Read a darknet .weights file into a new Darknet.

    allow_partial: darknet semantics; a truncated file (a pretrained
    backbone such as darknet53.conv.74) fills the leading layers and leaves
    the rest at their random init (`parser.c load_weights` stops at EOF).

    Returns (model, header) with header = int64[4] [major, minor, revision,
    seen] whatever the on-disk width of `seen`."""
    with open(path, "rb") as f:
        major, minor, revision = np.fromfile(f, dtype=np.int32, count=3)
        if major * 10 + minor >= 2 and major < 1000 and minor < 1000:
            seen = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        else:
            seen = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        header = np.array([major, minor, revision, seen], dtype=np.int64)
        stream = np.fromfile(f, dtype=np.float32)
    model = Darknet(spec, reso, generator)
    ptr = 0
    for l, m in conv_layers(model):
        names = (("bias", "weight", "running_mean", "running_var")
                 if m.bn is not None else ("bias",))
        need = len(names) * l.out_channels + m.conv.weight.numel()
        if ptr + need > len(stream):
            if allow_partial:
                break
            raise ValueError(f"weights file too short at offset {ptr}")
        target = m.bn if m.bn is not None else m.conv
        for name in names:
            getattr(target, name).copy_(torch.from_numpy(
                stream[ptr:ptr + l.out_channels].copy()))
            ptr += l.out_channels
        n = m.conv.weight.numel()
        m.conv.weight.copy_(torch.from_numpy(
            stream[ptr:ptr + n].reshape(m.conv.weight.shape).copy()))
        ptr += n
    return model, header


def save_darknet_weights(model: Darknet, path, seen: int = 0):
    """Write the model in the darknet .weights layout: int32 header
    [0, 1, 0, seen] (int32 `seen`, as the JAX writer and the vendored
    darknet fork emit), then per conv layer the BN arrays or the bias, then
    the OIHW weights."""
    buf = io.BytesIO()
    buf.write(np.array([0, 1, 0, seen], dtype=np.int32).tobytes())

    def w32(t):
        buf.write(t.detach().float().cpu().numpy().tobytes())

    for _, m in conv_layers(model):
        if m.bn is not None:
            for name in ("bias", "weight", "running_mean", "running_var"):
                w32(getattr(m.bn, name))
        else:
            w32(m.conv.bias)
        w32(m.conv.weight.contiguous())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
