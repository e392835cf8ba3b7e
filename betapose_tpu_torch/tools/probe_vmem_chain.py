"""Race the hand-written bottleneck-chain kernel against the cuDNN chain.

Counterpart of `betapose_tpu/tools/probe_vmem_chain.py`.  The same
1x1 -> 3x3 -> 1x1 residual-bottleneck math (`ops/kernels/bottleneck_chain`)
runs two ways on the card and one JSON line is printed per shape:

- `conv_ms` / `conv_mfu`: three bf16 `F.conv2d` calls (cuDNN,
  channels_last), relu, and the residual add in float32
  (`bottleneck_chain_cudnn`, the stock lowering the kernel is held to);
- `kernel_ms` / `kernel_mfu`: the CUDA kernel that keeps h1 and h2 in
  shared memory (`csrc/bottleneck_chain.cu`).

MFU is FLOPs over time over `PEAK_BF16`, the H100 SXM dense bf16 peak
(989 TFLOP/s, NVIDIA data sheet); each row names its card.  The shapes are
the pipeline's real bottleneck interiors:
- 13x13x1024 (Cm 512): darknet53 deep-stage block at YOLO-416;
- 10x8x2048  (Cm 512): SE-ResNet101 layer4 block at KPD 320x256;
- 20x16x1024 (Cm 256): SE-ResNet101 layer3 block;
and `--shallow` adds three cuDNN-only rows of the shallower darknet53
stages (26x26x512, 52x52x256, 104x104x128).

Agreement comes first (max |kernel - cuDNN| / max |cuDNN| < 0.05).  Times
are device time: K chained data-dependent calls between CUDA events after
a warm-up, the median of `--rounds` (`core/profiling.chain_ms`).  Every
row counts the kernel calls it made (`kernel_calls`), all of them eager,
so a caller can hold `bottleneck_chain.launches` to it.

The JAX tool's `--batch_tile` and its retry on a Mosaic VMEM overflow have
no counterpart: the CUDA kernel picks its own tile of positions per block,
and a shape it cannot take raises.

Run on the card:
    python -m betapose_tpu_torch.tools.probe_vmem_chain [--batch 96] [--k 20]
`--device cpu` runs both sides on the CPU (the plain chain stands in for
the kernel there; no device metric is printed), for the tests.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.core.profiling import chain_ms
from betapose_tpu_torch.ops.kernels import bottleneck_chain as bc

PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_NAME = "H100 SXM dense bf16, 989 TFLOP/s"

SHAPES = [(13, 13, 1024, 512),   # darknet53 deep stage @416
          (10, 8, 2048, 512),    # SE-R101 layer4 @320x256
          (20, 16, 1024, 256)]   # SE-R101 layer3 @320x256
SHALLOW = [(26, 26, 512, 256),   # darknet53 stage4 @416
           (52, 52, 256, 128),   # darknet53 stage3 @416
           (104, 104, 128, 64)]  # darknet53 stage2 (bandwidth)


def chain_conv_weights(w1, w2, w3):
    """The chain's weights as channels_last OIHW conv weights."""
    cin, cm = w1.shape
    cl = torch.channels_last
    return (w1.t().reshape(cm, cin, 1, 1).contiguous(memory_format=cl),
            w2.reshape(3, 3, cm, cm).permute(3, 2, 0, 1)
            .contiguous(memory_format=cl),
            w3.t().reshape(cin, cm, 1, 1).contiguous(memory_format=cl))


def bottleneck_chain_cudnn(x, w1c, w2c, w3c):
    """The chain as three stock convs on NHWC x (channels_last underneath):
    conv outputs in x's dtype, the residual added in float32."""
    xn = x.permute(0, 3, 1, 2)
    h1 = F.relu(F.conv2d(xn, w1c))
    h2 = F.relu(F.conv2d(h1, w2c, padding=1))
    y = F.relu(F.conv2d(h2, w3c).float() + xn.float()).to(x.dtype)
    return y.permute(0, 2, 3, 1)


def chain_inputs(b, h, w, cin, cm, device, seed=0):
    """bf16 chain inputs on `device` from numpy normals: x * 0.1 and
    He-scaled weights, so that the chain's own term is as large as the
    residual and a kernel that got the chain wrong fails the agreement
    check.  (The JAX probe's weights * 0.02 leave the chain a tenth of the
    residual, under the bar.)"""
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
    return (t((b, h, w, cin), 0.1), t((cin, cm), (2 / cin) ** .5),
            t((9, cm, cm), (2 / (9 * cm)) ** .5), t((cm, cin), cm ** -.5))


WARMUP = 2


def _timed(fn, x, k, rounds, device):
    state = [x]

    def step():
        state[0] = fn(state[0])
    return chain_ms(step, device, k=k, rounds=rounds, warmup=WARMUP)


def probe_shape(b, h, w, cin, cm, k=20, kernel=True, device="cuda",
                rounds=5):
    """One row: the cuDNN chain's time and, with kernel=True, the kernel's,
    after checking that the two agree."""
    device = torch.device(device)
    x, w1, w2, w3 = chain_inputs(b, h, w, cin, cm, device)
    convw = chain_conv_weights(w1, w2, w3)
    flops = bc.chain_flops(b, h, w, cin, cm)
    on_card = device.type == "cuda"

    def mfu(ms):
        return round(flops / (ms * 1e-3) / PEAK_BF16, 4) if on_card else None

    def conv_fn(v):
        return bottleneck_chain_cudnn(v, *convw)

    def kernel_fn(v):
        return bc.bottleneck_chain(v, w1, w2, w3)

    row = {"shape": f"{b}x{h}x{w}x{cin}->cm{cm}",
           "device": (torch.cuda.get_device_name(device) if on_card
                      else "cpu"),
           "flops_g": round(flops / 1e9, 2)}
    if kernel:
        ref = conv_fn(x).float()
        got = kernel_fn(x).float()
        scale = max(ref.abs().max().item(), 1e-6)
        max_rel = (ref - got).abs().max().item() / scale
        if not max_rel < 0.05:
            raise RuntimeError(f"kernel disagrees with cuDNN: {max_rel}")
    t_conv = _timed(conv_fn, x, k, rounds, device)
    row.update(conv_ms=round(t_conv, 4), conv_mfu=mfu(t_conv))
    if kernel:
        t_k = _timed(kernel_fn, x, k, rounds, device)
        row.update(kernel_ms=round(t_k, 4), kernel_mfu=mfu(t_k),
                   speedup=round(t_conv / t_k, 3),
                   max_rel_err=round(max_rel, 5),
                   kernel_calls=1 + WARMUP + k * rounds)
    row["mfu_peak"] = PEAK_NAME
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--k", type=int, default=20,
                   help="chained calls per timed round")
    p.add_argument("--rounds", type=int, default=5,
                   help="timed rounds; the median is reported")
    p.add_argument("--shallow", action="store_true",
                   help="also time the cuDNN chain at the shallow darknet53 "
                        "stages (no kernel rows there)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    shapes = [(*s, True) for s in SHAPES]
    if args.shallow:
        shapes += [(*s, False) for s in SHALLOW]
    rows = []
    for h, w, cin, cm, kernel in shapes:
        row = probe_shape(args.batch, h, w, cin, cm, args.k, kernel=kernel,
                          device=device, rounds=args.rounds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
