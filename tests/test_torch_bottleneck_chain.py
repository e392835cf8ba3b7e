"""The PyTorch port's bottleneck chain against the JAX package
(`betapose_tpu/ops/pallas/bottleneck_chain.py`).

The port's plain chain (what a CPU tensor runs) must match the JAX XLA
chain `bottleneck_chain_xla` and the Pallas kernel in interpret mode: in
float32 to atol = rtol = 1e-5 (the products sum in another order), in
bfloat16 on inputs where the chain's term is as large as the residual to
within one bf16 step of max|y| with at most 2% of the elements different
(both round at the same three points; an accumulation-order difference
can flip one rounding), a bar that a skipped chain or an unrounded h1
fails.  The CUDA kernel is held against the plain version on the card
(`cuda` marker; skipped without a GPU; run them there with `python -m
pytest tests/test_torch_bottleneck_chain.py -m cuda`).  The plain version runs its
products in full float32 whatever the process's TF32 setting.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from betapose_tpu.ops.pallas import bottleneck_chain as jax_bc  # noqa: E402
from betapose_tpu_torch.ops.kernels import bottleneck_chain as port_bc  # noqa: E402
from betapose_tpu_torch.tools import probe_vmem_chain  # noqa: E402


def _rand_chain(rng, b, h, w, cin, cm):
    """The JAX test's inputs, as float32 numpy arrays."""
    return ((rng.standard_normal((b, h, w, cin)) * 0.1).astype(np.float32),
            (rng.standard_normal((cin, cm)) * 0.05).astype(np.float32),
            (rng.standard_normal((9, cm, cm)) * 0.05).astype(np.float32),
            (rng.standard_normal((cm, cin)) * 0.05).astype(np.float32))


def _port(arrays, dtype):
    return port_bc.bottleneck_chain(
        *[torch.from_numpy(a).to(dtype) for a in arrays])


@pytest.mark.parametrize("b,h,w,cin,cm", [
    (2, 5, 4, 16, 8),     # odd spatial dims: the zero border is exercised
    (4, 3, 3, 8, 16),     # cm > cin
])
@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_plain_matches_jax_f32(b, h, w, cin, cm, ref):
    arrays = _rand_chain(np.random.default_rng(0), b, h, w, cin, cm)
    args = [jnp.asarray(a) for a in arrays]
    want = (jax_bc.bottleneck_chain_xla(*args) if ref == "xla" else
            jax_bc.bottleneck_chain_pallas(*args, h=h, w=w, batch_tile=b,
                                           interpret=True))
    got = _port(arrays, torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def _bf16_chain_case(ref):
    """The probe's bf16 inputs at (2,4,4,16,8) (He-scaled weights: the
    chain's term is as large as the residual) and JAX's chain on the same
    bf16 values, as float32 numpy."""
    bf = probe_vmem_chain.chain_inputs(2, 4, 4, 16, 8, "cpu", seed=2)
    args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf]
    want = (jax_bc.bottleneck_chain_xla(*args) if ref == "xla" else
            jax_bc.bottleneck_chain_pallas(*args, h=4, w=4, batch_tile=2,
                                           interpret=True))
    return bf, np.asarray(want, np.float32)


def _assert_bf16_bar(got, want):
    """Within one bf16 step (2**-7 relative to the leading bit) of max|y|,
    and at most 2% of the elements different at all: both sides round at
    the same three points, so only a summation-order difference can flip
    a rounding, and rarely."""
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    assert diff.max() <= step, f"max diff {diff.max()} > bf16 step {step}"
    assert (diff > 0).mean() <= 0.02, f"{(diff > 0).mean():.3f} differ"


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_plain_matches_jax_bf16(ref):
    bf, want = _bf16_chain_case(ref)
    _assert_bf16_bar(port_bc.bottleneck_chain(*bf).float().numpy(), want)


def _chain_h1_unrounded(x, w1, w2, w3):
    """The plain chain with h1 kept in float32 (one rounding point lost)."""
    b, h, w, cin = x.shape
    cm = w1.shape[1]
    xf = x.float().reshape(-1, cin)
    h1 = torch.relu(xf @ w1.float()).reshape(b, h, w, cm)
    hp = torch.nn.functional.pad(h1, (0, 0, 1, 1, 1, 1))
    acc = sum(hp[:, t // 3:t // 3 + h, t % 3:t % 3 + w].reshape(-1, cm)
              @ w2[t].float() for t in range(9))
    h2 = torch.relu(acc).to(x.dtype).float()
    return torch.relu(h2 @ w3.float() + xf).to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("wrong", ["relu_x", "h1_unrounded"])
def test_bf16_bar_rejects_a_wrong_chain(wrong):
    """The bar of `test_plain_matches_jax_bf16` fails a chain that is
    skipped (relu(x)) or that drops the rounding of h1."""
    bf, want = _bf16_chain_case("xla")
    got = (torch.relu(bf[0]) if wrong == "relu_x"
           else _chain_h1_unrounded(*bf))
    with pytest.raises(AssertionError):
        _assert_bf16_bar(got.float().numpy(), want)


def test_plain_ignores_the_tf32_setting():
    arrays = _rand_chain(np.random.default_rng(3), 1, 3, 3, 8, 8)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        out = _port(arrays, torch.float32)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(out.numpy(),
                                  _port(arrays, torch.float32).numpy())


@pytest.mark.parametrize("shape", [(1, 2, 2, 4, 8), (96, 13, 13, 1024, 512),
                                   (96, 10, 8, 2048, 512)])
def test_chain_flops_equal_jax(shape):
    assert port_bc.chain_flops(*shape) == jax_bc.chain_flops(*shape)


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    arrays = [torch.from_numpy(a) for a in
              _rand_chain(np.random.default_rng(4), 2, 3, 2, 8, 8)]
    before = port_bc.bottleneck_chain.launches
    out = port_bc.bottleneck_chain(*arrays)
    assert port_bc.bottleneck_chain.launches == before
    assert torch.equal(out, port_bc.bottleneck_chain_plain(*arrays))


@pytest.mark.parametrize("bad", ["float64", "mixed_dtype", "w1_shape",
                                 "w2_shape", "w3_shape", "x_rank",
                                 "x_strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w1, w2, w3 = [torch.from_numpy(a) for a in
                     _rand_chain(np.random.default_rng(5), 2, 4, 4, 16, 8)]
    exc = ValueError
    if bad == "float64":
        x, w1, w2, w3, exc = x.double(), w1.double(), w2.double(), \
            w3.double(), TypeError
    elif bad == "mixed_dtype":
        w2, exc = w2.bfloat16(), TypeError
    elif bad == "w1_shape":
        w1 = w1[:8]
    elif bad == "w2_shape":
        w2 = w2[:8]
    elif bad == "w3_shape":
        w3 = w3[:, :8]
    elif bad == "x_rank":
        x = x[0]
    else:
        x = x.transpose(1, 2)
    with pytest.raises(exc):
        port_bc.bottleneck_chain(x, w1, w2, w3)


def test_probe_shape_conv_only_row():
    """The `--shallow` rows: the cuDNN chain's time only; no device metric
    on the CPU."""
    row = probe_vmem_chain.probe_shape(2, 3, 3, 8, 4, k=2, kernel=False,
                                       device="cpu", rounds=1)
    assert set(row) == {"shape", "device", "flops_g", "conv_ms", "conv_mfu",
                        "mfu_peak"}
    assert row["shape"] == "2x3x3x8->cm4" and row["device"] == "cpu"
    assert row["conv_ms"] > 0 and row["conv_mfu"] is None


def test_probe_shape_kernel_row():
    row = probe_vmem_chain.probe_shape(2, 5, 4, 16, 8, k=2, device="cpu",
                                       rounds=2)
    assert set(row) == {"shape", "device", "flops_g", "conv_ms", "conv_mfu",
                        "kernel_ms", "kernel_mfu", "speedup", "max_rel_err",
                        "kernel_calls", "mfu_peak"}
    assert row["max_rel_err"] < 0.05
    assert row["kernel_calls"] == 1 + probe_vmem_chain.WARMUP + 2 * 2
    assert row["kernel_ms"] > 0 and row["kernel_mfu"] is None


def test_probe_shape_rejects_a_kernel_that_skips_the_chain(monkeypatch):
    """On the probe's inputs the chain's term is as large as the residual,
    so the agreement check fails a kernel that returns relu(x)."""
    monkeypatch.setattr(port_bc, "bottleneck_chain",
                        lambda x, *w: torch.relu(x))
    with pytest.raises(RuntimeError, match="disagrees"):
        probe_vmem_chain.probe_shape(2, 5, 4, 16, 8, k=1, device="cpu",
                                     rounds=1)


def test_probe_main_prints_one_row_per_shape(capsys, monkeypatch):
    monkeypatch.setattr(probe_vmem_chain, "SHAPES",
                        [(3, 3, 8, 8), (1, 13, 16, 8)])
    rows = probe_vmem_chain.main(["--device", "cpu", "--batch", "1", "--k",
                                  "1", "--rounds", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(s) for s in lines] == rows and len(rows) == 2


def test_probe_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_vmem_chain.main(["--batch", "1"])


def _kernel_vs_plain(shape):
    """The kernel's output on the probe's inputs at `shape`, held within
    2e-2 of max|plain| (chip_smoke's bar), with one launch counted."""
    args = probe_vmem_chain.chain_inputs(*shape, "cuda")
    before = port_bc.bottleneck_chain.launches
    out = port_bc.bottleneck_chain(*args)
    torch.cuda.synchronize()
    assert port_bc.bottleneck_chain.launches == before + 1
    ref = port_bc.bottleneck_chain_plain(*args).float()
    assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from betapose_tpu_torch.core.device import resolve_device
    resolve_device("cuda")                  # TF32 off


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 5, 4, 16, 8), (4, 3, 3, 8, 16), (1, 1, 1, 8, 8), (2, 1, 13, 64, 32),
    (8, 13, 13, 1024, 512),
    (2, 6, 7, 24, 40),     # Cin, Cm not multiples of 64: A's M side padded
    (2, 5, 5, 8, 8),       # 35 and 49 positions: widths past the count
    (3, 9, 1, 16, 8),      # W = 1
    (1, 30, 30, 512, 512),  # 30 row bands
    (2, 40, 90, 64, 32),   # row and column bands
])
def test_kernel_matches_plain_on_card(shape):
    _need_card()
    _kernel_vs_plain(shape)


@pytest.mark.cuda
def test_kernel_takes_every_width_on_card():
    """One-row frames of width 1..80 take every width instance of the
    kernel (the squeeze's halo grid grows by 3 positions a column), and
    each agrees with the plain version."""
    _need_card()
    widths = set()
    for w in range(1, 81):
        _kernel_vs_plain((1, 1, w, 8, 8))
        widths.update(port_bc.kernel_plan(1, 1, w, 8, 8)["widths"])
    assert widths == set(port_bc.KERNEL_WIDTHS)
