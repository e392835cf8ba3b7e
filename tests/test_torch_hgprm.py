"""The PyTorch port's hgPRM (PyraNet) against the JAX package
(`betapose_tpu/models/hgprm.py`) on the CPU in float32, at a small size:
6 keypoints, nFeats 16, nStack 2, 64x64 crops -> 16x16 heatmaps, with
parameters and inputs drawn with numpy.

- the port's `state_dict` converts back through the JAX
  `torch_state_dict_to_params` with no entry left over, to the same tree
  (this pins the reference module names);
- every head agrees with the JAX `forward(..., all_heads=True)` to rtol
  1e-4 (absolute floor 1e-4 of the head's largest value);
- the segment-max pool is exactly the JAX one, the align-corners resize
  within 1e-6;
- `calibrate_bn` writes the JAX running statistics (the stem's to 1e-5,
  the hourglass's to 1e-4: see the test);
- a JAX `save_pytree_npz` checkpoint loads into the port's PyraNet and
  gives the JAX heads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.core import checkpoint as jax_ckpt  # noqa: E402
from betapose_tpu.models import hgprm as jax_hg  # noqa: E402
from betapose_tpu_torch.core import checkpoint as port_ckpt  # noqa: E402
from betapose_tpu_torch.models import hgprm as port_hg  # noqa: E402

N_KP, N_FEATS, N_STACK = 6, 16, 2
NET = dict(n_feats=N_FEATS, n_stack=N_STACK)


def random_hgprm_params(n_kp, seed, **net):
    """JAX PyraNet params drawn with numpy: the tree of `hgprm.init_params`
    (traced for its shapes), xavier-scaled convs, small biases and
    non-trivial batch-norm statistics."""
    shapes = jax.eval_shape(
        lambda: jax_hg.init_params(jax.random.PRNGKey(0), n_kp, **net))
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0.0, 0.1, s),
            "mean": lambda s: rng.normal(0.0, 0.1, s),
            "var": lambda s: rng.uniform(0.5, 2.0, s),
            "b": lambda s: rng.normal(0.0, 0.05, s)}

    def fill(path, leaf):
        name, s = path[-1].key, leaf.shape
        a = (draw[name](s) if name in draw else rng.standard_normal(s)
             * np.sqrt(2.0 / (np.prod(s[:3]) + np.prod(s[:2]) * s[3])))
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_model(params, n_kp=N_KP, **net):
    model = port_hg.PyraNet(n_kp, **(net or NET))
    model.load_state_dict(port_hg.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def _heads_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


@pytest.fixture(scope="module")
def nets():
    params = random_hgprm_params(N_KP, 0, **NET)
    x = np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    heads = jax.jit(lambda p, v: jax_hg.forward(p, v, all_heads=True))(
        params, jnp.asarray(x))
    ref = [np.asarray(h).transpose(0, 3, 1, 2) for h in heads]  # [B,K,H,W]
    return params, port_model(params), x, ref


def test_state_dict_converts_back_to_jax_params(nets):
    params, model, _, _ = nets
    back = jax_hg.torch_state_dict_to_params(model.state_dict(), N_KP,
                                             **NET)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert len(flat_a) == 1050
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == \
        [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_all_heads_match(nets):
    _, model, x, ref = nets
    with torch.no_grad():
        heads = model(torch.from_numpy(x), all_heads=True)
        last = model(torch.from_numpy(x))
    _heads_close([h.numpy() for h in heads], ref)
    assert torch.equal(last, heads[-1])
    assert last.shape == (2, N_KP, 16, 16)


def test_npz_checkpoint_loads(nets, tmp_path):
    """A JAX `save_pytree_npz` PyraNet loads through the port's
    `load_kpd_checkpoint` and gives the JAX heads."""
    params, _, x, ref = nets
    path = str(tmp_path / "seq1_model.npz")
    jax_ckpt.save_pytree_npz(path, params)
    model = port_ckpt.load_kpd_checkpoint(path, N_KP, "hgPRM", **NET)
    with torch.no_grad():
        heads = model(torch.from_numpy(x), all_heads=True)
    _heads_close([h.numpy() for h in heads], ref)


def test_pkl_checkpoint_loads(nets, tmp_path):
    """A reference-named PyraNet state_dict ('module.' keys) loads
    natively through `load_kpd_checkpoint`."""
    _, model, x, ref = nets
    path = str(tmp_path / "seq1_model.pkl")
    torch.save({"module." + k: v for k, v in model.state_dict().items()},
               path)
    loaded = port_ckpt.load_kpd_checkpoint(path, N_KP, "hgPRM", **NET)
    with torch.no_grad():
        _heads_close([loaded(torch.from_numpy(x)).numpy()], ref[-1:])


@pytest.mark.parametrize("shape,out", [
    ((2, 3, 13, 11), (9, 7)), ((1, 2, 5, 6), (3, 3)), ((1, 4, 16, 16),
                                                        (13, 13)),
    ((2, 1, 7, 9), (1, 1)), ((1, 2, 8, 8), (8, 8)), ((1, 3, 32, 20),
                                                     (16, 11))])
def test_adaptive_max_pool_is_exactly_jax(shape, out):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = port_hg.adaptive_max_pool(torch.from_numpy(x), *out).numpy()
    ref = np.asarray(jax_hg.adaptive_max_pool(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *out)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, ref)


def test_adaptive_max_pool_is_not_torch_adaptive():
    """Where the bins of `F.adaptive_max_pool2d` overlap, the port's
    segment-max binning differs from it: the two must not be swapped."""
    x = torch.tensor([0.0, 9.0, 0.0, 5.0, 0.0]).repeat(1, 1, 5, 1)
    ours = port_hg.adaptive_max_pool(x, 3, 3)
    theirs = torch.nn.functional.adaptive_max_pool2d(x, (3, 3))
    assert ours[0, 0, 0].tolist() == [9.0, 5.0, 0.0]     # bins {0,1},{2,3},{4}
    assert theirs[0, 0, 0].tolist() == [9.0, 9.0, 5.0]   # [0,2),[1,4),[3,5)


@pytest.mark.parametrize("shape,out", [
    ((1, 3, 5, 7), (10, 14)), ((2, 2, 4, 3), (16, 16)),
    ((1, 2, 1, 6), (4, 9)), ((1, 1, 6, 6), (6, 6))])
def test_bilinear_resize_ac_matches_jax(shape, out):
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    got = port_hg.bilinear_resize_ac(torch.from_numpy(x), *out).numpy()
    ref = np.asarray(jax_hg._bilinear_resize_ac(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *out)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_calibrate_bn_matches_jax():
    """On a one-stack net at 256x256: the stem's statistics (before the
    hourglass) to 1e-5 of each statistic's largest value, the hourglass's
    to 1e-4, the forward's bar.  Inside the hourglass each batch norm
    normalizes by its batch's own statistics, which amplifies the float32
    summation-order differences of the layers before it, the more so the
    fewer values a channel has (at 64x64 crops the innermost level is 1x1,
    2 values per channel at batch 2, and its statistics drift to 2e-4)."""
    net = dict(n_feats=N_FEATS, n_stack=1)
    params = random_hgprm_params(N_KP, 4, **net)
    model = port_model(params, **net)
    x = np.random.default_rng(5).standard_normal(
        (2, 256, 256, 3)).astype(np.float32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = jax.jit(lambda p, v: jax_hg.calibrate_bn(p, v, momentum=0.7))(
        params, jnp.asarray(x))
    cal = port_hg.calibrate_bn(model, torch.from_numpy(x), momentum=0.7)
    for k, v in model.state_dict().items():          # input left as it is
        assert torch.equal(v, before[k]), k
    back = jax_hg.torch_state_dict_to_params(cal.state_dict(), N_KP, **net)
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    n_stats = 0
    for (p, r), (_, b) in zip(flat_r, flat_b):
        r, b, key = np.asarray(r), np.asarray(b), jax.tree_util.keystr(p)
        if p[-1].key not in ("mean", "var"):
            np.testing.assert_array_equal(b, r, err_msg=key)
            continue
        n_stats += 1
        bar = 1e-4 if key.startswith("['stacks']") else 1e-5
        np.testing.assert_allclose(b, r, rtol=bar, atol=bar * np.abs(r).max(),
                                   err_msg=key)
    assert n_stats == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                              for m in model.modules())


def test_init_is_seeded_and_xavier_scaled():
    a = port_hg.PyraNet(N_KP, generator=torch.Generator().manual_seed(1),
                        **NET)
    b = port_hg.PyraNet(N_KP, generator=torch.Generator().manual_seed(1),
                        **NET)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.preact[0][0].weight                   # 7x7 3->64, gain sqrt(1/3)
    std = np.sqrt(1 / 3) * np.sqrt(2.0 / (3 * 49 + 64 * 49))
    assert abs(w.std().item() / std - 1) < 0.05
    assert all(torch.equal(m.bias, torch.zeros_like(m.bias))
               for m in a.modules() if isinstance(m, torch.nn.Conv2d))
