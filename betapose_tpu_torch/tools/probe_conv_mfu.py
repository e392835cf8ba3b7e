"""Per-op conv and matmul rates on the card, timed as chains.

Counterpart of `betapose_tpu/tools/probe_conv_mfu.py`.  K applications of
one bf16 op are chained (x -> op(x), so no call can be skipped) between
CUDA events after a warm-up, and the median of `--rounds` over K is the
op's device time (`core/profiling.chain_ms`).  Six chains answer the
questions the conv stack's time rests on:

- 3x3 conv at 13x13 against 16x16 (x1024): what the odd grid costs;
- 1x1 conv at 13x13x1024 against the same product as a reshape-matmul
  [B*169,1024]@[1024,1024]: whether rewriting 1x1 convs as matmuls pays;
- 3x3 conv at 26x26x512, the detector's mid stage;
- [8192,1024]@[1024,1024], a large product for reference.

Weights are scaled by 1/sqrt(fan_in) so the chained bf16 activations stay
bounded.  MFU divides by the H100 SXM dense bf16 peak (989 TFLOP/s, NVIDIA
data sheet).  The JAX tool's `--int8` mode has no counterpart: PyTorch has
no int8 convolution on CUDA, so `--int8` raises.

Run on the card:
    python -m betapose_tpu_torch.tools.probe_conv_mfu [--k 40] [--batch 64]
One JSON line per op.  `--device cpu` is for the tests.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from betapose_tpu_torch.core.device import resolve_device
from betapose_tpu_torch.core.profiling import chain_ms
from betapose_tpu_torch.tools.probe_vmem_chain import PEAK_BF16, PEAK_NAME

WIDTH = 1024        # the deep stage's channels (the mid stage has half)


def _bf16(rng, shape, scale, device):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(torch.bfloat16).to(device)


def conv_chain(b, h, c, size, device):
    """(step function, FLOPs per step, label) of a chained c->c conv."""
    rng = np.random.default_rng(0)
    x = _bf16(rng, (b, c, h, h), 1.0, device).contiguous(
        memory_format=torch.channels_last)
    w = _bf16(rng, (c, c, size, size), 1.0 / np.sqrt(size * size * c),
              device).contiguous(memory_format=torch.channels_last)
    state = [x]

    def step():
        state[0] = F.conv2d(state[0], w, padding=(size - 1) // 2)
    return step, 2 * b * h * h * c * c * size * size, \
        f"conv{size}x{size} {h}x{h}x{c}"


def matmul_chain(m, c, device, label=None):
    rng = np.random.default_rng(0)
    x = _bf16(rng, (m, c), 1.0, device)
    w = _bf16(rng, (c, c), 1.0 / np.sqrt(c), device)
    state = [x]

    def step():
        state[0] = state[0] @ w
    return step, 2 * m * c * c, label or f"matmul [{m},{c}]@[{c},{c}]"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=40, help="ops chained per round")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed rounds; the median is reported")
    ap.add_argument("--int8", action="store_true",
                    help="not available: PyTorch has no int8 convolution "
                         "on CUDA (raises)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.int8:
        raise NotImplementedError(
            "--int8: PyTorch has no int8 convolution on CUDA; the bf16 "
            "chains are the port's probe")
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    b, c = args.batch, WIDTH
    chains = [conv_chain(b, 13, c, 3, device),      # YOLO deep, odd grid
              conv_chain(b, 16, c, 3, device),      # aligned control
              conv_chain(b, 13, c, 1, device),      # 1x1 bottleneck
              matmul_chain(b * 13 * 13, c, device,
                           f"mm-as-1x1 [{b * 169},{c}]@[{c},{c}]"),
              conv_chain(b, 26, c // 2, 3, device),  # YOLO mid
              matmul_chain(8 * c, c, device)]       # large product
    rows = []
    for step, flops, label in chains:
        ms = chain_ms(step, device, k=args.k, rounds=args.rounds)
        tflops = flops / (ms * 1e-3) / 1e12
        row = {"op": label,
               "device": (torch.cuda.get_device_name(device) if on_card
                          else "cpu"),
               "ms": round(ms, 4),
               "tflops": round(tflops, 2) if on_card else None,
               "mfu": (round(tflops * 1e12 / PEAK_BF16, 4) if on_card
                       else None),
               "mfu_peak": PEAK_NAME}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
