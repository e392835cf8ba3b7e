"""The port reads the JAX package's `.npz` KPD checkpoints
(`betapose_tpu/core/checkpoint.save_pytree_npz`: one array per leaf of the
param tree, keyed by its `jax.tree_util.keystr` path) with numpy only.

- a FastPose (resnet50, 64x32 crop, 4 keypoints) saved by JAX loads into
  the port and gives the JAX heatmaps (rtol 1e-4, as tests/test_torch_kpd);
- the keystr paths rebuild the nested dict/list tree exactly;
- a missing leaf raises KeyError naming its path (or its innermost
  missing parent), as the JAX loader names it;
- `default_kpd_path` finds a lone `.npz`.
(The PyraNet case is in tests/test_torch_hgprm.py.)
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.core import checkpoint as jax_ckpt  # noqa: E402
from betapose_tpu.models import kpd as jax_kpd  # noqa: E402
from betapose_tpu_torch.core import checkpoint as port_ckpt  # noqa: E402
from tests.test_torch_kpd import N_KP, random_kpd_params  # noqa: E402


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    params = random_kpd_params(N_KP, "resnet50", 3)
    path = str(tmp_path_factory.mktemp("ckpt") / "seq1_model.npz")
    jax_ckpt.save_pytree_npz(path, params)
    return params, path


def test_fastpose_npz_gives_the_jax_heatmaps(saved):
    params, path = saved
    x = np.random.default_rng(1).standard_normal(
        (2, 64, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_kpd.forward)(
        params, jnp.asarray(x))).transpose(0, 3, 1, 2)
    model = port_ckpt.load_kpd_checkpoint(path, N_KP, "resnet50")
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _plain(tree):
    """The rebuilt tree with plain dicts, which jax.tree_util walks."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def test_npz_tree_is_the_jax_tree(saved):
    params, path = saved
    tree = _plain(port_ckpt.load_pytree_npz(path))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in back] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    for (_, a), (_, b) in zip(flat, back):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a))
    assert isinstance(tree["layer3"], list) and len(tree["layer3"]) == 6


@pytest.mark.parametrize("missing", [
    "['layer1'][0]['bn1']['mean']", "['conv_out']['b']",
    "['duc2']['conv']['w']", "['layer4'][1]['conv3']['w']"])
def test_a_missing_key_raises_with_its_name(saved, tmp_path, missing):
    _, path = saved
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != missing}
    assert len(arrays) == len(np.load(path).files) - 1
    cut = str(tmp_path / "cut.npz")
    np.savez(cut, **arrays)
    with pytest.raises(KeyError) as err:
        port_ckpt.load_kpd_checkpoint(cut, N_KP, "resnet50")
    # the missing leaf, or its innermost missing parent (a dict whose only
    # leaf it was)
    named = str(err.value).strip("\"'").split("checkpoint missing ")[1]
    assert named in (missing, missing[:missing.rindex("[")]), named


def test_a_gap_in_a_list_raises_with_its_name(tmp_path):
    path = str(tmp_path / "gap.npz")
    np.savez(path, **{"['a'][0]['w']": np.zeros(2),
                      "['a'][2]['w']": np.ones(2)})
    with pytest.raises(KeyError, match=r"\['a'\]\[1\]"):
        port_ckpt.load_pytree_npz(path)


@pytest.mark.parametrize("key", ["['a'].w", "a", "['a']['b'", "[x]"])
def test_a_malformed_key_raises(tmp_path, key):
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{key: np.zeros(2)})
    with pytest.raises(ValueError, match="keystr"):
        port_ckpt.load_pytree_npz(path)


def test_default_kpd_path_finds_a_lone_npz(saved, tmp_path):
    base = str(tmp_path)
    assert port_ckpt.default_kpd_path(1, base) == os.path.join(
        base, "seq1_model.pkl")                      # nothing there yet
    npz = os.path.join(base, "seq1_model.npz")
    os.symlink(saved[1], npz)
    assert port_ckpt.default_kpd_path(1, base) == npz
    pkl = os.path.join(base, "seq1_model.pkl")
    open(pkl, "wb").close()
    assert port_ckpt.default_kpd_path(1, base) == pkl  # the reference's first


def test_an_unknown_extension_raises(tmp_path):
    path = str(tmp_path / "seq1_model.ckpt")
    open(path, "wb").close()
    with pytest.raises(ValueError, match=".npz"):
        port_ckpt.load_kpd_checkpoint(path, N_KP, "resnet50")
