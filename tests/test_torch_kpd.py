"""The PyTorch port's FastPose against the JAX package
(`betapose_tpu/models/kpd.py`): SE-ResNet50 + DUC at a 64x32 input with 4
keypoints, float32 on the CPU.  The same parameters reach both sides
through `state_dict_from_jax`; heatmaps agree to rtol 1e-4 (with an
absolute floor of 1e-4 of the largest value, for the entries near zero
where the summation order shows); the port's
`state_dict` converts back through the JAX `torch_state_dict_to_params`
unchanged, which pins the reference module names."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.models import kpd as jax_kpd  # noqa: E402
from betapose_tpu_torch.core import checkpoint as port_ckpt  # noqa: E402
from betapose_tpu_torch.models import kpd as port_kpd  # noqa: E402

N_KP = 4


def random_kpd_params(n_kp, arch, seed):
    """JAX FastPose params drawn with numpy: the tree of `kpd.init_params`
    (traced for its shapes, not run: running it eagerly takes ~15 s), with
    He-normal convs, uniform linears and output conv, and non-trivial
    batch-norm statistics so that BN and its folding are exercised."""
    shapes = jax.eval_shape(
        lambda: jax_kpd.init_params(jax.random.PRNGKey(0), n_kp, arch))
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda n: rng.uniform(0.5, 1.5, n),
            "bias": lambda n: rng.normal(0.0, 0.1, n),
            "mean": lambda n: rng.normal(0.0, 0.1, n),
            "var": lambda n: rng.uniform(0.5, 2.0, n)}

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in draw:
            a = draw[name](shape)
        elif "conv_out" in jax.tree_util.keystr(path):
            a = rng.uniform(-1, 1, shape) / np.sqrt(128 * 9)
        elif len(shape) == 4:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        else:                                   # SE linears {"w", "b"}
            a = rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def nets():
    params = random_kpd_params(N_KP, "resnet50", 0)
    model = port_kpd.FastPose(N_KP, "resnet50")
    model.load_state_dict(port_kpd.state_dict_from_jax(params))
    x = np.random.default_rng(1).standard_normal(
        (2, 64, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_kpd.forward)(params, jnp.asarray(x)))
    return params, model, x, ref.transpose(0, 3, 1, 2)  # -> [B,K,H,W]


def _hm_close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_heatmaps_match(nets):
    _, model, x, ref = nets
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == (2, N_KP, 16, 8)
    _hm_close(out, ref)


def test_state_dict_converts_back_to_jax_params(nets):
    params, model, _, _ = nets
    back = jax_kpd.torch_state_dict_to_params(model.state_dict(), N_KP,
                                              "resnet50")
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == \
        [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_fold_bn_is_equivalent(nets):
    params, model, x, ref = nets
    folded = port_kpd.fold_bn(model)
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    with torch.no_grad():
        out = folded(torch.from_numpy(x)).numpy()
    _hm_close(out, ref)
    jax_folded = np.asarray(jax.jit(jax_kpd.forward)(
        jax_kpd.fold_bn(params), jnp.asarray(x))).transpose(0, 3, 1, 2)
    _hm_close(out, jax_folded)


def test_checkpoint_roundtrip(nets, tmp_path):
    """A reference-style DataParallel checkpoint ('module.' keys) loads
    natively through `load_kpd_checkpoint`."""
    _, model, x, ref = nets
    path = str(tmp_path / "seq1_model.pkl")
    torch.save({"module." + k: v for k, v in model.state_dict().items()},
               path)
    loaded = port_ckpt.load_kpd_checkpoint(path, N_KP, "resnet50")
    with torch.no_grad():
        _hm_close(loaded(torch.from_numpy(x)).numpy(), ref)
    assert port_ckpt.default_kpd_path(1, str(tmp_path)) == path


def test_se_gate_only_on_downsample_blocks():
    model = port_kpd.FastPose(N_KP, "resnet101")
    blocks = [b for li in range(1, 5)
              for b in getattr(model.preact, f"layer{li}")]
    assert len(blocks) == 3 + 4 + 23 + 3
    assert [b.se is not None for b in blocks] == \
        [b.downsample is not None for b in blocks]
    assert sum(b.se is not None for b in blocks) == 4


def test_init_is_seeded():
    a = port_kpd.FastPose(N_KP, "resnet50", torch.Generator().manual_seed(1))
    b = port_kpd.FastPose(N_KP, "resnet50", torch.Generator().manual_seed(1))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb)
