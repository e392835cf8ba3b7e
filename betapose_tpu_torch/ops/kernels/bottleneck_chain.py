"""Residual bottleneck chain: the hand-written CUDA kernel and its plain
version.

Replaces the TPU kernel `betapose_tpu/ops/pallas/bottleneck_chain.py`
(`bottleneck_chain_pallas`).  Both functions here compute, for NHWC x
[B,H,W,Cin] and BN-folded weights w1 [Cin,Cm], w2 [9,Cm,Cm] (3x3 taps,
row-major dy, dx) and w3 [Cm,Cin],

    h1 = relu(x @ w1)                  rounded to x's dtype
    h2 = relu(conv3x3(h1, w2))         zero border; rounded to x's dtype
    y  = relu(f32(h2 @ w3) + f32(x))   rounded to x's dtype

with float32 accumulation: the semantics of the JAX `bottleneck_chain_xla`.
The chain is on no model path; `tools/probe_vmem_chain.py` races it against
the cuDNN conv chain.

`bottleneck_chain` takes the plain version only for tensors on the CPU; a
CUDA tensor goes through the kernel (`csrc/bottleneck_chain.cu`, on wgmma)
or raises.  `kernel_plan` reports the kernel's tile, blocks and product
widths for a shape.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from betapose_tpu_torch.ops.kernels import build

SOURCE = "bottleneck_chain.cu"

# the product widths (wgmma N, positions) the kernel has an instance for
KERNEL_WIDTHS = tuple(range(16, 257, 16))


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matmuls in full float32 (no TF32) for the block, whatever
    the process set."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def bottleneck_chain_plain(x, w1, w2, w3):
    """The chain in plain PyTorch ops: products in float32 from the input
    values (full float32 on the card too, TF32 off inside), rounded to x's
    dtype at the JAX points.  The 3x3 is nine shifted [S,Cm]@[Cm,Cm]
    products over a zero-padded h1.  Takes float32 or bfloat16."""
    dt = x.dtype
    b, h, w, cin = x.shape
    cm = w1.shape[1]
    with _full_f32_matmul():
        xf = x.float().reshape(-1, cin)
        h1 = torch.relu(xf @ w1.to(dt).float()).to(dt)
        hp = F.pad(h1.float().reshape(b, h, w, cm), (0, 0, 1, 1, 1, 1))
        w2f = w2.to(dt).float()
        acc = torch.zeros((b * h * w, cm), dtype=torch.float32,
                          device=x.device)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            acc += hp[:, dy:dy + h, dx:dx + w].reshape(-1, cm) @ w2f[tap]
        h2 = torch.relu(acc).to(dt)
        y = torch.relu(h2.float() @ w3.to(dt).float() + xf).to(dt)
    return y.reshape(b, h, w, cin)


def chain_flops(b, h, w, cin, cm):
    """MAC-pair FLOPs of the chain (residual/relu excluded, as in the
    PROFILE.md per-op accounting)."""
    s = b * h * w
    return 2 * s * cin * cm + 9 * 2 * s * cm * cm + 2 * s * cm * cin


def _check(x, w1, w2, w3):
    ts = (x, w1, w2, w3)
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bottleneck_chain runs on cpu or cuda, not "
                         f"{dev.type}")
    if any(t.device != dev for t in ts):
        raise ValueError("bottleneck_chain takes x and weights on one device")
    allowed = ((torch.bfloat16,) if dev.type == "cuda"
               else (torch.bfloat16, torch.float32))
    if any(t.dtype != x.dtype for t in ts) or x.dtype not in allowed:
        raise TypeError(
            f"bottleneck_chain on {dev.type} takes x and weights all of one "
            f"dtype in {[str(d) for d in allowed]}, got "
            f"{[str(t.dtype) for t in ts]}")
    if x.dim() != 4:
        raise ValueError(f"bottleneck_chain takes x [B,H,W,Cin], got "
                         f"{tuple(x.shape)}")
    b, h, w, cin = x.shape
    if w1.dim() != 2 or w1.shape[0] != cin:
        raise ValueError(f"w1 must be [Cin={cin}, Cm], got {tuple(w1.shape)}")
    cm = w1.shape[1]
    if tuple(w2.shape) != (9, cm, cm):
        raise ValueError(f"w2 must be [9, {cm}, {cm}], got {tuple(w2.shape)}")
    if tuple(w3.shape) != (cm, cin):
        raise ValueError(f"w3 must be [{cm}, {cin}], got {tuple(w3.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("bottleneck_chain takes contiguous tensors")
    if dev.type == "cuda":
        if cin % 8 or cm % 8 or min(h, w, cin, cm) < 1:
            raise ValueError(f"the kernel takes Cin and Cm in multiples of 8 "
                             f"and H, W >= 1, got H={h} W={w} Cin={cin} "
                             f"Cm={cm}")
        if b > 65535 or max(t.numel() for t in ts) >= 2 ** 31:
            raise ValueError("the kernel takes B <= 65535 and tensors of "
                             "fewer than 2**31 elements")
        if any(t.data_ptr() % 16 for t in ts):
            raise ValueError("the kernel takes 16-byte aligned tensors")


def _entry():
    fn = build.load(SOURCE).bottleneck_chain_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kernel_plan(b, h, w, cin, cm):
    """The tile the CUDA kernel takes for x [B,H,W,Cin] and Cm on the current
    CUDA device: {"tile": (rows, cols), "blocks", "smem_bytes", "widths":
    (squeeze, 3x3, expand)}, the widths being the wgmma N (positions) of
    the three products.  Raises ValueError when no tile fits."""
    fn = build.load(SOURCE).bottleneck_chain_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    if fn(b, h, w, cin, cm, out) != 0:
        raise ValueError(f"the kernel takes no tile for H={h} W={w} "
                         f"Cin={cin} Cm={cm}")
    return {"tile": (out[0], out[1]), "blocks": out[2],
            "smem_bytes": out[3], "widths": (out[4], out[5], out[6])}


def _launch(x, w1, w2, w3):
    b, h, w, cin = x.shape
    cm = w1.shape[1]
    y = torch.empty_like(x)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                 y.data_ptr(), b, h, w, cin, cm, stream)
    if err != 0:
        raise RuntimeError(f"bottleneck_chain kernel launch failed: CUDA "
                           f"error {err} (H={h} W={w} Cin={cin} Cm={cm}; "
                           f"error 1 also means no tile fits Cm in shared "
                           f"memory)")
    bottleneck_chain.launches += 1
    return y


def bottleneck_chain(x, w1, w2, w3):
    """x [B,H,W,Cin] -> y [B,H,W,Cin], the residual bottleneck chain.

    A CPU tensor takes `bottleneck_chain_plain` (float32 or bfloat16); a
    CUDA tensor launches the kernel (bfloat16 only, Cin and Cm multiples of
    8), counts the launch in `bottleneck_chain.launches`, or raises.  All
    four tensors must be contiguous and of one dtype.

    The JAX kernel's `h`, `w`, `batch_tile` and `interpret` arguments have
    no counterpart: H and W come from x's shape, the CUDA kernel picks its
    own tile of positions per block, and there is no
    interpreter (a CPU tensor runs the plain version)."""
    _check(x, w1, w2, w3)
    if x.device.type == "cpu":
        return bottleneck_chain_plain(x, w1, w2, w3)
    return _launch(x, w1, w2, w3)


bottleneck_chain.launches = 0
