"""Space-to-depth stem for YOLOv3 and FastPose: an exact rewrite.

Counterpart of `betapose_tpu/models/stem_s2d.py`.  The first two darknet-53
layers (conv 3x3/1 3->32 at full resolution, conv 3x3/2 32->64) run with
tiny channel counts; in the space-to-depth domain they become

  x [B,H,W,3] --s2d(2)--> xp [B,H/2,W/2,12]        (phase-major packing)
  conv1 3x3/1 (3->32)  ==> conv 3x3/1 (12->128), the four phases of the
                           original conv1 output, packed
  leaky (elementwise: commutes with the packing permutation)
  conv2 3x3/2 (32->64) ==> conv 2x2/1 (128->64), top/left pad 1

and FastPose's 7x7/2 stem conv becomes a 4x4/1 conv on the packed input
(`conv_stride2_via_s2d`).  The weight maps follow from index algebra on
y = 2i + py - 1 + ky; every slot of a packed weight receives at most one
original value, so the packed weights equal the JAX package's bit for bit,
and the network computes the same function up to summation order.

The public functions keep the JAX layouts (NHWC activations, HWIO
weights); inside, the networks run NCHW.  Whether the rewrite pays on the
card is measured by `chip_smoke.py`, not assumed from the TPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from betapose_tpu_torch.models.yolov3 import (LEAKY_SLOPE, bf16_values,
                                              cached, conv_bf16)


def space_to_depth2(x):
    """[B,H,W,C] -> [B,H/2,W/2,4C], channel = (py*2+px)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _space_to_depth2_nchw(x):
    """[B,C,H,W] -> [B,4C,H/2,W/2] with the channel order of
    `space_to_depth2`."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def pack_conv1_weights(w):
    """[3,3,Cin,Cout] (s1 conv, HWIO) -> [3,3,4*Cin,4*Cout] packed conv.

    For output phase (py,px) and tap (ky,kx): input row y = 2i+py-1+ky =
    2(i+d)+q with d = floor((py-1+ky)/2), q = (py-1+ky) mod 2; kernel row
    r = d+1.  Same along x."""
    kh, kw, cin, cout = w.shape
    assert kh == 3 and kw == 3
    out = torch.zeros((3, 3, 4 * cin, 4 * cout), dtype=w.dtype,
                      device=w.device)
    for py in range(2):
        for px in range(2):
            for ky in range(3):
                dy, qy = divmod(py - 1 + ky, 2)
                for kx in range(3):
                    dx, qx = divmod(px - 1 + kx, 2)
                    ci = (qy * 2 + qx) * cin
                    co = (py * 2 + px) * cout
                    out[dy + 1, dx + 1, ci:ci + cin,
                        co:co + cout] += w[ky, kx]
    return out


def pack_conv1_bias(b):
    return b.repeat(4)


def pack_conv2_weights(w):
    """[3,3,Cin,Cout] (s2 conv, HWIO) -> [2,2,4*Cin,Cout]: the output grid
    is the stride-2 lattice; y = 2i-1+ky = 2(i+d)+q with
    d = floor((ky-1)/2) in {-1,0}, q = (ky-1) mod 2; kernel row r = d+1."""
    kh, kw, cin, cout = w.shape
    assert kh == 3 and kw == 3
    out = torch.zeros((2, 2, 4 * cin, cout), dtype=w.dtype, device=w.device)
    for ky in range(3):
        dy, qy = divmod(ky - 1, 2)
        for kx in range(3):
            dx, qx = divmod(kx - 1, 2)
            ci = (qy * 2 + qx) * cin
            out[dy + 1, dx + 1, ci:ci + cin] += w[ky, kx]
    return out


def pack_stride2_conv_weights(w):
    """[k,k,Cin,Cout] stride-2 'same'-padded conv (odd k, HWIO) ->
    s2d-domain stride-1 conv [k2,k2,4*Cin,Cout] with asymmetric padding.

    For output (i,j): input row y = 2i - k//2 + ky = 2(i+d) + q with
    d = floor((ky - k//2)/2), q = (ky - k//2) mod 2.  Returns
    (packed_w, (pad_before, pad_after)) where pad_before = -d_min,
    pad_after = d_max in s2d pixels."""
    kh, kw, cin, cout = w.shape
    assert kh == kw and kh % 2 == 1
    half = kh // 2
    ds = [int(np.floor((ky - half) / 2)) for ky in range(kh)]
    d_min, d_max = min(ds), max(ds)
    k2 = d_max - d_min + 1
    out = torch.zeros((k2, k2, 4 * cin, cout), dtype=w.dtype,
                      device=w.device)
    for ky in range(kh):
        dy, qy = divmod(ky - half, 2)
        for kx in range(kw):
            dx, qx = divmod(kx - half, 2)
            ci = (qy * 2 + qx) * cin
            out[dy - d_min, dx - d_min, ci:ci + cin] += w[ky, kx]
    return out, (-d_min, d_max)


def _oihw(w_hwio):
    return w_hwio.permute(3, 2, 0, 1).contiguous()


def _hwio(w_oihw):
    return w_oihw.permute(2, 3, 1, 0)


def _conv_s2d_nchw(xp, w_oihw, bias, pads):
    """Stride-1 conv of the packed input with (before, after) padding on
    both spatial axes."""
    pb, pa = pads
    return F.conv2d(F.pad(xp, (pb, pa, pb, pa)), w_oihw, bias)


def _memory_format(t):
    """The layout of the conv weight t (channels_last on the card)."""
    return (torch.channels_last if t.is_contiguous(
        memory_format=torch.channels_last) and not t.is_contiguous()
        else torch.contiguous_format)


def _stride2_packed(conv: torch.nn.Conv2d):
    """(packed OIHW weight, pads) of a stride-2 'same' conv module."""
    def build():
        packed, pads = pack_stride2_conv_weights(_hwio(conv.weight))
        return (_oihw(packed).to(memory_format=_memory_format(conv.weight)),
                pads)
    return cached(conv, "_s2d_packed", (conv.weight,), build)


def conv_stride2_via_s2d(x, w):
    """Exact stride-2 'same' conv via space-to-depth + stride-1 conv.
    x: [B,H,W,Cin] (H, W even); w: [k,k,Cin,Cout] HWIO (odd k).  Returns
    [B,H/2,W/2,Cout] in x's dtype."""
    packed, pads = pack_stride2_conv_weights(w)
    xp = _space_to_depth2_nchw(x.permute(0, 3, 1, 2))
    y = _conv_s2d_nchw(xp, _oihw(packed).to(x.dtype), None, pads)
    return y.permute(0, 2, 3, 1)


def fastpose_stem_s2d(conv: torch.nn.Conv2d, x_nchw):
    """FastPose's 7x7/2 stem conv (with its bias, when batch norm is
    folded) through `conv_stride2_via_s2d`'s rewrite; NCHW in and out."""
    packed, pads = _stride2_packed(conv)
    return _conv_s2d_nchw(_space_to_depth2_nchw(x_nchw), packed, conv.bias,
                          pads)


def stem_applicable(spec):
    """True when layers 0/1 are the darknet-53 stem pattern and layer 0's
    output is never referenced by a route/shortcut."""
    if len(spec.layers) < 2:
        return False
    l0, l1 = spec.layers[0], spec.layers[1]
    return (l0.kind == "conv" and l0.size == 3 and l0.stride == 1
            and l0.pad == 1 and l1.kind == "conv" and l1.size == 3
            and l1.stride == 2 and l1.pad == 1
            and 0 not in spec.cache_idxs
            and l0.activation == "leaky" and l1.activation == "leaky")


def pack_stem_params(model):
    """Packed HWIO weights and biases of layers 0 and 1 of a Darknet whose
    batch norms are folded (`yolov3.fold_bn`): {"w1", "b1", "w2", "b2"}."""
    c0, c1 = model.layers[0].conv, model.layers[1].conv
    return {"w1": pack_conv1_weights(_hwio(c0.weight)),
            "b1": pack_conv1_bias(c0.bias),
            "w2": pack_conv2_weights(_hwio(c1.weight)),
            "b2": c1.bias}


def _stem_packed(model):
    """`pack_stem_params` in OIHW, in the layout of the model's weights."""
    c0, c1 = model.layers[0].conv, model.layers[1].conv

    def build():
        p = pack_stem_params(model)
        fmt = _memory_format(c0.weight)
        return _with_bf16_values(
            {"w1": _oihw(p["w1"]).to(memory_format=fmt), "b1": p["b1"],
             "w2": _oihw(p["w2"]).to(memory_format=fmt), "b2": p["b2"]})
    return cached(model, "_s2d_packed",
                  (c0.weight, c0.bias, c1.weight, c1.bias), build)


def _with_bf16_values(packed):
    """The OIHW packed stem with its weights rounded to bf16 beside them
    (held in float32), for bf16 inputs."""
    return {**packed, "w1_bf16": bf16_values(packed["w1"]),
            "w2_bf16": bf16_values(packed["w2"])}


def _stem_nchw(packed, x_nchw):
    xp = _space_to_depth2_nchw(x_nchw)
    if x_nchw.dtype == torch.bfloat16:
        # the JAX stem's numerics: float32 sums, bias and leaky, each conv
        # rounded to bf16 once (`yolov3.conv_bf16`)
        y = conv_bf16(xp, packed["w1_bf16"], packed["b1"], padding=1,
                      activation="leaky")
        return conv_bf16(F.pad(y, (1, 0, 1, 0)), packed["w2_bf16"],
                         packed["b2"], activation="leaky")
    y = F.leaky_relu(F.conv2d(xp, packed["w1"], packed["b1"], padding=1),
                     LEAKY_SLOPE)
    z = _conv_s2d_nchw(y, packed["w2"], packed["b2"], (1, 0))
    return F.leaky_relu(z, LEAKY_SLOPE)


def stem_forward(packed, x):
    """x: [B,H,W,3] -> layer-1 output [B,H/2,W/2,C1] (exact), from the
    HWIO `pack_stem_params` dict."""
    oihw = _with_bf16_values({"w1": _oihw(packed["w1"]), "b1": packed["b1"],
                              "w2": _oihw(packed["w2"]), "b2": packed["b2"]})
    return _stem_nchw(oihw, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def forward_with_s2d_stem(model, x, decode=True):
    """`Darknet.forward` with the packed stem.  Where the rewrite does not
    apply (another stem, or batch norm not folded), this is the standard
    forward: the JAX function's rule, and the same function either way."""
    if (not stem_applicable(model.spec) or model.layers[0].bn is not None
            or model.layers[1].bn is not None):
        return model(x, decode=decode)
    y = _stem_nchw(_stem_packed(model), x.permute(0, 3, 1, 2))
    return model.run_layers(y, start=2, cache={1: y}, decode=decode)
