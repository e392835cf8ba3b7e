"""Heatmap peak decode: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel `betapose_tpu/ops/pallas/heatmap_decode.py`
(`decode_peaks`).  Both functions here map hms [B,K,H,W] float32 to
[B,K,4] = (x, y, maxval, 0) in heatmap coordinates with the reference's
semantics (`KPD/src/utils/eval.py:113-141`): first-occurrence argmax, x and
y zeroed unless maxval > 0, +-0.25 gradient-sign refinement on strict-
interior peaks, +0.2 offset.

`decode_peaks` takes the plain version only for a tensor on the CPU; a CUDA
tensor goes through the kernel (`csrc/heatmap_decode.cu`) or raises.  The
two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from betapose_tpu_torch.ops.kernels import build

SOURCE = "heatmap_decode.cu"


def decode_peaks_plain(hms):
    """The decode in plain PyTorch ops, in the order of the JAX package's
    XLA path (`betapose_tpu/ops/heatmap.py:102-129`)."""
    n, k, h, w = hms.shape
    flat = hms.reshape(n, k, h * w)
    maxval = flat.amax(dim=2)
    idx = flat.argmax(dim=2)

    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    mask = (maxval > 0).float()
    x = x * mask
    y = y * mask

    px = torch.round(x).long()
    py = torch.round(y).long()
    interior = ((px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)).float()
    flat_idx = py.clamp(1, h - 2) * w + px.clamp(1, w - 2)

    def at(offset):
        return flat.gather(2, (flat_idx + offset)[..., None])[..., 0]

    dx = torch.sign(at(1) - at(-1)) * 0.25
    dy = torch.sign(at(w) - at(-w)) * 0.25
    fx = x + dx * interior + 0.2
    fy = y + dy * interior + 0.2
    return torch.stack([fx, fy, maxval, torch.zeros_like(maxval)], dim=-1)


def _check(hms):
    if hms.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_peaks runs on cpu or cuda, not "
                         f"{hms.device.type}")
    if hms.dtype != torch.float32:
        raise TypeError(f"decode_peaks takes float32 heatmaps, got {hms.dtype}")
    if hms.dim() != 4:
        raise ValueError(f"decode_peaks takes [B,K,H,W], got {tuple(hms.shape)}")
    if not hms.is_contiguous():
        raise ValueError("decode_peaks takes a contiguous tensor")
    _, _, h, w = hms.shape
    if h * w == 0 or h * w >= 2 ** 31:
        raise ValueError(f"decode_peaks takes maps of 1 to 2**31-1 elements, "
                         f"got {h}x{w}")


def _entry():
    fn = build.load(SOURCE).decode_peaks_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(hms):
    b, k, h, w = hms.shape
    out = torch.empty((b, k, 4), dtype=torch.float32, device=hms.device)
    maps = b * k
    if maps == 0:
        return out
    fn = _entry()
    vec = int((h * w) % 4 == 0 and hms.data_ptr() % 16 == 0)
    with torch.cuda.device(hms.device):
        stream = torch.cuda.current_stream(hms.device).cuda_stream
        err = fn(hms.data_ptr(), out.data_ptr(), maps, h, w, vec, stream)
    if err != 0:
        raise RuntimeError(f"decode_peaks kernel launch failed: CUDA error "
                           f"{err}")
    decode_peaks.launches += 1
    return out


def decode_peaks(hms):
    """hms [B,K,H,W] float32 -> [B,K,4] (x, y, maxval, 0).

    A CPU tensor takes `decode_peaks_plain`; a CUDA tensor launches the
    kernel (and counts the launch in `decode_peaks.launches`) or raises.
    Both take only contiguous float32 [B,K,H,W] tensors."""
    _check(hms)
    if hms.device.type == "cpu":
        return decode_peaks_plain(hms)
    return _launch(hms)


decode_peaks.launches = 0
