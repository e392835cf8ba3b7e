"""The port's KPD inference wrappers (`betapose_tpu_torch/models/inference`)
against the JAX package's (`betapose_tpu/models/inference.py`) on the CPU:
the same `.pkl` state_dict through both loaders, float32, heatmaps within
rtol 1e-4 (the JAX wrappers return NHWC, the port [B,K,H,W])."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from betapose_tpu.models import inference as jax_inf  # noqa: E402
from betapose_tpu_torch.models import inference as port_inf  # noqa: E402
from betapose_tpu_torch.models import kpd as port_kpd  # noqa: E402

N_KP = 6


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model = port_kpd.FastPose(N_KP, "resnet50",
                              torch.Generator().manual_seed(3))
    with torch.no_grad():                 # non-trivial BN statistics
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 2.0)
    path = tmp_path_factory.mktemp("kpd") / "seq1_model.pkl"
    torch.save(model.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("cls", ["InferenNetFast", "InferenNet"])
def test_wrappers_match_jax(checkpoint, monkeypatch, cls):
    # the JAX wrapper loads resnet101; this checkpoint is resnet50
    monkeypatch.setattr(jax_inf.ckpt, "load_kpd_checkpoint", functools.partial(
        jax_inf.ckpt.load_kpd_checkpoint, arch="resnet50"))
    x = np.random.default_rng(0).random((2, 64, 32, 3), np.float32) - 0.45
    ref = np.asarray(getattr(jax_inf, cls)(
        weights_path=checkpoint, n_classes=N_KP)(x)).transpose(0, 3, 1, 2)
    out = getattr(port_inf, cls)(weights_path=checkpoint, n_classes=N_KP,
                                 arch="resnet50", device="cpu")(x).numpy()
    assert out.shape == ref.shape == (2, N_KP, 16, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_missing_checkpoint_falls_back_to_a_seeded_init(tmp_path):
    x = np.random.default_rng(1).random((1, 64, 32, 3), np.float32)
    nets = [port_inf.InferenNetFast(obj_id=1, n_classes=N_KP,
                                    model_base=str(tmp_path), arch="resnet50",
                                    device="cpu") for _ in range(2)]
    a, b = (net(x) for net in nets)
    assert a.shape == (1, N_KP, 16, 8) and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_wrappers_need_cuda_unless_cpu_is_asked_for(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_inf.InferenNetFast(weights_path=checkpoint, arch="resnet50")
