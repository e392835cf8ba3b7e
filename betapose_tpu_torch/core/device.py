"""Device resolution and the numeric pins the port runs under.

Every entry point (`PosePipeline`, `build_pipeline`, the CLI) takes
`device=None`, which means CUDA.  Without a CUDA device that raises: the
port never carries on quietly on the CPU.  The CPU is used only when the
caller asks for it (`device="cpu"`), as the tests do.

Precision policy (the JAX package's, CLAUDE.md "Environment gotchas"): the
conv path runs bf16 with f32 accumulation; coordinates, resampling weights,
decode and PnP stay true f32.  cuDNN runs f32 convolutions in TF32 by
default, the GPU analogue of the TPU's bf16-pass trap, so `resolve_device`
turns TF32 off for both cuDNN and cuBLAS whenever it hands out a CUDA device.
This is the one place the port sets those flags.
"""

from __future__ import annotations

import torch


def pin_fp32_precision() -> None:
    """Make float32 convolutions and matmuls on the card true float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda".  A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        pin_fp32_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
