"""Time two shallow-stage levers of the detector on the card.

Counterpart of `betapose_tpu/tools/probe_s2d_stage.py`:

1. **s2d past the stem**: the 104^2 darknet53 stage (two residual
   bottlenecks, 1x1 128->64 + 3x3 64->128) rewritten exactly in the 52^2
   space-to-depth domain: grouped 1x1s (4 phase-independent groups) and
   the packed 3x3 of `models/stem_s2d.pack_conv1_weights`.  Activation
   bytes are the same in both domains (52^2*512 == 104^2*128) while the
   packed 3x3 does 4x the dense FLOPs, so the rewrite can only win where
   the plain stage's convs run far below the card's rates.
2. **fusing the 416^2 resize into the stem**: the resize pass alone
   (480x640 uint8 -> 416^2 bf16, the separable matmuls the pipeline runs)
   bounds what any fusion of it could save.

Times are device time: K calls in a row between CUDA events after a
warm-up, the median of `--rounds` (`core/profiling.chain_ms`); the stage
calls are chained (each takes the last one's output).  MFU divides by the
H100 SXM dense bf16 peak (989 TFLOP/s, NVIDIA data sheet).

Run on the card:
    python -m betapose_tpu_torch.tools.probe_s2d_stage [--batch 96] [--k 20]
One JSON line per measurement.  `--device cpu` is for the tests.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.core.profiling import chain_ms
from betapose_tpu_torch.models.stem_s2d import (pack_conv1_weights,
                                                space_to_depth2)
from betapose_tpu_torch.models.yolov3 import LEAKY_SLOPE
from betapose_tpu_torch.ops.image import resize_bilinear_matmul
from betapose_tpu_torch.tools.probe_vmem_chain import PEAK_BF16, PEAK_NAME

STAGE = (104, 104, 128)        # darknet53 stage 2 at 416: H, W, C
RESIZE = ((480, 640), 416)     # LineMod frames -> the YOLO input


def _oihw(w):
    """HWIO -> channels_last OIHW, the layout cuDNN takes."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _conv(x, w_oihw, groups=1):
    """'SAME' stride-1 conv of NHWC x (odd k)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw,
                 padding=w_oihw.shape[-1] // 2, groups=groups)
    return y.permute(0, 2, 3, 1)


def _leaky(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def _blocks(x, convs, groups):
    """Residual blocks x + leaky(conv(leaky(conv(x, w1)), w2)) over the
    (w1, w2) OIHW pairs of `convs`; the 1x1s take `groups`."""
    for w1, w2 in convs:
        y = _leaky(_conv(x, w1, groups))
        y = _leaky(_conv(y, w2))
        x = x + y
    return x


def normal_convs(w1a, w2a, w1b, w2b):
    return ((_oihw(w1a), _oihw(w2a)), (_oihw(w1b), _oihw(w2b)))


def s2d_convs(w1a, w2a, w1b, w2b):
    """The s2d domain's weights: each 1x1 C->C/2 repeated for the 4 groups
    of a grouped 1x1 4C->4C/2 (phases never mix through a 1x1), each
    3x3/s1 C/2->C packed to a 3x3 4C/2->4C (`pack_conv1_weights`, the
    index algebra of the stem's conv1)."""
    return tuple((_oihw(torch.cat([w1] * 4, dim=3)),
                  _oihw(pack_conv1_weights(w2)))
                 for w1, w2 in ((w1a, w2a), (w1b, w2b)))


def stage_normal(x, w1a, w2a, w1b, w2b):
    """Two darknet53 residual bottlenecks at native resolution
    (1x1 C->C/2 leaky, 3x3 C/2->C leaky, add).  NHWC x, HWIO weights."""
    return _blocks(x, normal_convs(w1a, w2a, w1b, w2b), 1)


def stage_s2d(xp, w1a, w2a, w1b, w2b):
    """The same two blocks in the s2d(2) domain (`s2d_convs`); leaky and
    the residual add are elementwise and commute with the packing
    permutation.  xp is `space_to_depth2(x)`; weights HWIO."""
    return _blocks(xp, s2d_convs(w1a, w2a, w1b, w2b), 4)


def _mfu(flops, ms, on_card):
    return round(flops / (ms * 1e-3) / PEAK_BF16, 4) if on_card else None


def _chained(fn, x, k, rounds, device):
    state = [x]

    def step():
        state[0] = fn(state[0])
    return chain_ms(step, device, k=k, rounds=rounds)


def probe_stage(b=96, h=104, w=104, c=128, k=20, device="cuda", rounds=5):
    device = torch.device(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)

    def t(shape, scale):
        return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                .to(torch.bfloat16) * scale).to(device)
    x = t((b, h, w, c), 0.1)
    ws = (t((1, 1, c, c // 2), 0.05), t((3, 3, c // 2, c), 0.05),
          t((1, 1, c, c // 2), 0.05), t((3, 3, c // 2, c), 0.05))

    convs_n, convs_s = normal_convs(*ws), s2d_convs(*ws)

    def fn_n(v):
        return _blocks(v, convs_n, 1)

    def fn_s(v):
        return _blocks(v, convs_s, 4)

    # exactness of the rewrite (up to bf16 summation order)
    ref = space_to_depth2(fn_n(x)).float()
    got = fn_s(space_to_depth2(x)).float()
    scale = max(ref.abs().max().item(), 1e-6)
    max_rel = (ref - got).abs().max().item() / scale
    if not max_rel < 0.05:
        raise RuntimeError(f"s2d stage disagrees: {max_rel}")

    # dense FLOPs each way (the packed 3x3 pays 4x; its zeros are computed)
    fl_n = 2 * b * h * w * (c * c // 2 + 9 * (c // 2) * c) * 2
    fl_s = 2 * b * (h // 2) * (w // 2) * (
        4 * c * (c // 2) + 9 * (4 * c // 2) * (4 * c)) * 2

    t_n = _chained(fn_n, x, k, rounds, device)
    t_s = _chained(fn_s, space_to_depth2(x).contiguous(), k, rounds, device)
    return {
        "probe": f"s2d_stage_{h}x{w}x{c}_b{b}",
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "max_rel_err": round(max_rel, 5),
        "normal_ms": round(t_n, 4),
        "normal_mfu": _mfu(fl_n, t_n, on_card),
        "s2d_ms": round(t_s, 4),
        "s2d_dense_gflop_ratio": round(fl_s / fl_n, 2),
        "speedup": round(t_n / t_s, 3),
        "mfu_peak": PEAK_NAME,
    }


def probe_resize(b=96, k=20, device="cuda", rounds=5, src=(480, 640),
                 reso=416):
    """The det stage's resize pass (uint8 frames -> reso^2 bf16 through the
    separable matmuls the pipeline runs) timed alone: the ceiling of any
    resize-into-stem fusion."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 255, (b, *src, 3),
                                           dtype=np.uint8)).to(device)

    def step():
        resize_bilinear_matmul(frames.to(torch.bfloat16) / 255.0, reso, reso)
    ms = chain_ms(step, device, k=k, rounds=rounds)
    return {"probe": f"resize_{src[0]}x{src[1]}->{reso}_b{b}",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "resize_ms": round(ms, 4),
            "ms_per_frame": round(ms / b, 5)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--skip_resize", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rows = [probe_stage(args.batch, *STAGE, args.k, device, args.rounds)]
    if not args.skip_resize:
        rows.append(probe_resize(args.batch, args.k, device, args.rounds,
                                 *RESIZE))
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main()
