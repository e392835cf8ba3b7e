"""The conv precision modes of KPD training (`--trainPrecision`).

Counterpart of the JAX package's `matmul_precision` in
`train/kpd_train.make_loss_fn`, which runs the train step's forward and
backward under `jax.default_matmul_precision(mode)`.  Activations, batch
norm, the loss and the optimizer stay float32 in every mode; only the
conv operands change:

- "float32": float32 convs with TF32 off (the pin of `core/device.py`);
- "tensorfloat32": cuDNN may run float32 convs on TF32 tensor cores;
- "bfloat16" (the JAX default): each conv takes its input and weight
  rounded to bf16 values and runs as a float32 conv with TF32 allowed.  A
  bf16 value is exact in TF32, so the products are exact and the sums
  float32, as the TPU's bf16 passes with float32 accumulation are.

The rounding is straight-through: its gradient is the identity, so the
gradients stay float32 between convs, as they do under JAX's precision
setting.  (`x.bfloat16().float()` would round every conv's gradient to
bf16 in its backward.)  cuBLAS keeps TF32 off in every mode: the matmuls
outside the convs (the SE gates, hgPRM's resizes, which the JAX package
pins to float32) stay float32.  On the CPU the TF32 flag does nothing.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

TRAIN_PRECISIONS = ("bfloat16", "tensorfloat32", "float32")


def round_bf16(x):
    """x rounded to bf16 values, kept float32, with an identity gradient.
    The forward value is exactly the rounded one: r - x is exact for r
    within half a bf16 ulp of x, and x + (r - x) then rounds to r."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` (same parameters, same `state_dict` names) that rounds
    its operands to bf16 values when `precision` is "bfloat16".  The
    attribute is set by `conv_precision` for the train step; it is
    "float32" otherwise, and the conv is then `nn.Conv2d`'s."""

    precision = "float32"

    def forward(self, x):
        if self.precision != "bfloat16":
            return super().forward(x)
        return self._conv_forward(round_bf16(x), round_bf16(self.weight),
                                  self.bias)


@contextlib.contextmanager
def conv_precision(model: nn.Module, mode: str):
    """Run `model`'s convs in `mode` inside the block, forward and
    backward both: cuDNN reads its TF32 flag when a conv's backward runs,
    so the backward belongs inside the block too.  The convs' modes and
    the flag are restored on exit."""
    if mode not in TRAIN_PRECISIONS:
        raise ValueError(f"unknown train precision {mode!r}: one of "
                         f"{TRAIN_PRECISIONS}")
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    prev_tf32 = torch.backends.cudnn.allow_tf32
    for m in convs:
        m.precision = mode
    torch.backends.cudnn.allow_tf32 = mode != "float32"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
        for m in convs:
            m.precision = "float32"
