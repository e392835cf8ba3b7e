"""The PyTorch port's heatmap peak decode against the JAX package.

The port's plain decode (what a CPU tensor runs) must equal the JAX XLA
path (`betapose_tpu/ops/heatmap.py`) and the Pallas kernel in interpret mode
(`betapose_tpu/ops/pallas/heatmap_decode.py`) EXACTLY in coordinates and
maxval: every step is exact or rounds once in the same order.  Image
coordinates agree to 1e-4 px.  The CUDA kernel is held against the plain
version on the card (`cuda` marker; skipped without a GPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from betapose_tpu.ops import heatmap as jax_hm  # noqa: E402
from betapose_tpu.ops.pallas.heatmap_decode import (  # noqa: E402
    decode_peaks as jax_decode_peaks)
from betapose_tpu_torch.ops import heatmap as port_hm  # noqa: E402
from betapose_tpu_torch.ops.kernels import heatmap_decode as port_dec  # noqa: E402


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _border_maps(h, w):
    """One map per border position: 4 corners and 4 edge midpoints, plus a
    strict-interior peak next to the border."""
    spots = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1),
             (0, w // 2), (h - 1, w // 2), (h // 2, 0), (h // 2, w - 1),
             (1, 1)]
    maps = np.full((1, len(spots), h, w), 0.1, np.float32)
    for k, (y, x) in enumerate(spots):
        maps[0, k, y, x] = 2.0
        if 0 < x < w - 1:
            maps[0, k, y, x + 1] = 1.5   # right > left: +0.25 if interior
    return maps


def make_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        return rng.standard_normal((2, 5, 16, 12)).astype(np.float32)
    if name == "bf16_ties":
        # bf16-quantized maps with the maximum planted 3 times per map, in
        # row-major order that the first occurrence must win
        m = _bf16(rng.uniform(0, 1, (2, 5, 16, 12)).astype(np.float32))
        for b in range(2):
            for k in range(5):
                for f in rng.choice(16 * 12, 3, replace=False):
                    m[b, k, f // 12, f % 12] = 1.0
        return m
    if name == "all_negative":
        return -rng.uniform(0.1, 1.0, (2, 3, 16, 12)).astype(np.float32)
    if name == "all_zero":
        return np.zeros((2, 3, 16, 12), np.float32)
    if name == "border_peaks":
        return _border_maps(16, 12)
    if name == "main_path_shape":
        # K=50 at 80x64, the main path's map size, bf16-quantized
        return _bf16(rng.standard_normal((2, 50, 80, 64)).astype(np.float32))
    raise KeyError(name)


CASES = ["random", "bf16_ties", "all_negative", "all_zero", "border_peaks",
         "main_path_shape"]


@pytest.mark.parametrize("case", CASES)
def test_plain_decode_equals_pallas_interpret(case):
    hms = make_case(case)
    ref = np.asarray(jax_decode_peaks(jnp.asarray(hms), interpret=True))
    out = port_dec.decode_peaks(torch.from_numpy(hms)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("case", CASES)
def test_decode_heatmaps_equals_xla_path(case):
    hms = make_case(case)
    n = hms.shape[0]
    rng = np.random.default_rng(1)
    pt1 = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    pt2 = (pt1 + rng.uniform(40, 300, (n, 2))).astype(np.float32)
    h, w = hms.shape[2:]
    inp_h, inp_w = 4 * h, 4 * w
    preds, preds_img, maxval = jax_hm.decode_heatmaps(
        jnp.asarray(hms), jnp.asarray(pt1), jnp.asarray(pt2),
        inp_h, inp_w, h, w)
    p_preds, p_img, p_max = port_hm.decode_heatmaps(
        torch.from_numpy(hms), torch.from_numpy(pt1), torch.from_numpy(pt2),
        inp_h, inp_w, h, w)
    np.testing.assert_array_equal(p_preds.numpy(), np.asarray(preds))
    np.testing.assert_array_equal(p_max.numpy(), np.asarray(maxval))
    np.testing.assert_allclose(p_img.numpy(), np.asarray(preds_img),
                               rtol=0, atol=1e-4)


def test_first_occurrence_wins_on_ties():
    hms = np.zeros((1, 1, 6, 5), np.float32)
    hms[0, 0, 2, 4] = 1.0     # row-major first of the three
    hms[0, 0, 3, 1] = 1.0
    hms[0, 0, 4, 3] = 1.0
    out = port_dec.decode_peaks(torch.from_numpy(hms)).numpy()
    # (4, 2) is on the right border: no refinement, +0.2 offset
    np.testing.assert_array_equal(out[0, 0],
                                  np.float32([4.2, 2.2, 1.0, 0.0]))


def test_heatmap_concentration_matches_jax():
    rng = np.random.default_rng(3)
    hms = rng.standard_normal((2, 4, 16, 12)).astype(np.float32)
    hms[1, 2] = -1.0
    ref = np.asarray(jax_hm.heatmap_concentration(jnp.asarray(hms)))
    out = port_hm.heatmap_concentration(torch.from_numpy(hms)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    assert out[1, 2] == 0.0


@pytest.mark.parametrize("bad", ["float64", "rank3", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    hms = torch.zeros((2, 3, 8, 8))
    if bad == "float64":
        hms, exc = hms.double(), TypeError
    elif bad == "rank3":
        hms, exc = hms[0], ValueError
    else:
        hms, exc = hms.transpose(2, 3), ValueError
    with pytest.raises(exc):
        port_dec.decode_peaks(hms)


def test_cpu_tensor_takes_plain_version_without_counting():
    before = port_dec.decode_peaks.launches
    port_dec.decode_peaks(torch.zeros((1, 2, 4, 4)))
    assert port_dec.decode_peaks.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_bitwise_equals_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    hms = torch.from_numpy(make_case(case)).cuda()
    before = port_dec.decode_peaks.launches
    out = port_dec.decode_peaks(hms)
    torch.cuda.synchronize()
    assert port_dec.decode_peaks.launches == before + 1
    assert torch.equal(out, port_dec.decode_peaks_plain(hms))
