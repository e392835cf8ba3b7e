"""The PyTorch port's YOLOv3 against the JAX package
(`betapose_tpu/models/yolov3.py`): the full single-class YOLOv3 graph
(75 convs, 3 heads) at reso 64, float32 on the CPU, the same parameters on
both sides through `params_from_jax`.  Decoded detections agree to
rtol 1e-4 (the convs sum in another order).  The darknet .weights file is
the second bridge, checked both ways."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu.models.darknet_cfg import make_yolov3_cfg  # noqa: E402
from betapose_tpu_torch.models import yolov3 as port_yolo  # noqa: E402
from betapose_tpu_torch.models import darknet_cfg as port_cfg  # noqa: E402

RESO = 64
CFG = make_yolov3_cfg(num_classes=1, width=RESO, height=RESO)


@pytest.fixture(scope="module")
def nets():
    """JAX params with non-trivial batch-norm statistics (so folding is
    exercised), and the port's Darknet holding the same numbers."""
    spec = jax_yolo.build_spec(CFG)
    # the tree of `init_params` (traced for its shapes, not run: running it
    # eagerly takes seconds), filled with numpy: He-normal convs, and
    # non-trivial batch-norm statistics so that folding is exercised
    shapes = jax.eval_shape(
        lambda: jax_yolo.init_params(jax.random.PRNGKey(0), spec))
    rng = np.random.default_rng(0)
    draw = {"bn_scale": lambda n: rng.uniform(0.5, 1.5, n),
            "bn_bias": lambda n: rng.normal(0.0, 0.1, n),
            "bn_mean": lambda n: rng.normal(0.0, 0.1, n),
            "bn_var": lambda n: rng.uniform(0.5, 2.0, n),
            "b": lambda n: np.zeros(n),
            "w": lambda s: rng.standard_normal(s) * np.sqrt(
                2.0 / np.prod(s[:3]))}
    params = [{k: jnp.asarray(draw[k](v.shape), jnp.float32)
               for k, v in p.items()} for p in shapes]
    x = np.random.default_rng(1).random((2, RESO, RESO, 3), np.float32)
    # the random residual stack grows activations to ~1e3 at the heads;
    # scale each head conv so its raw outputs are O(1) and exp(tw) stays
    # finite (the comparison is of the decode, not of float overflow)
    heads = jax.jit(lambda p, x: jax_yolo.forward(spec, p, x, RESO,
                                                  decode=False))(
        params, jnp.asarray(x))
    head_convs = [i - 1 for i in spec.yolo_idxs]
    for i, h in zip(head_convs, heads):
        s = 1.0 / float(jnp.std(h))
        params[i] = {"w": params[i]["w"] * s, "b": params[i]["b"] * s}
    port_spec = port_yolo.build_spec(CFG)
    model = port_yolo.params_from_jax(
        port_spec, [{k: np.asarray(v) for k, v in p.items()} for p in params],
        RESO)
    return spec, params, port_spec, model, x


def _assert_dets_close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_cfg_copy_matches():
    assert port_cfg.make_yolov3_cfg(num_classes=1, width=RESO,
                                    height=RESO) == CFG


def test_decoded_detections_match(nets):
    spec, params, _, model, x = nets
    ref = np.asarray(jax.jit(lambda p, x: jax_yolo.forward(spec, p, x, RESO))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 3 * (4 + 16 + 64), 6)
    _assert_dets_close(out, ref)


def test_fold_bn_matches_jax_fold(nets):
    spec, params, _, model, x = nets
    folded_params = jax_yolo.fold_bn(spec, params)
    ref = np.asarray(jax.jit(lambda p, x: jax_yolo.forward(spec, p, x, RESO))(
        folded_params, jnp.asarray(x)))
    folded = port_yolo.fold_bn(model)
    assert all(m.bn is None for _, m in port_yolo.conv_layers(folded))
    with torch.no_grad():
        out = folded(torch.from_numpy(x)).numpy()
    _assert_dets_close(out, ref)
    # the JAX fold output loads as a folded port model, too
    from_folded = port_yolo.params_from_jax(
        port_yolo.build_spec(CFG),
        [{k: np.asarray(v) for k, v in p.items()} for p in folded_params],
        RESO)
    with torch.no_grad():
        _assert_dets_close(from_folded(torch.from_numpy(x)).numpy(), ref)


def _conv_arrays(model):
    out = []
    for _, m in port_yolo.conv_layers(model):
        out.append(m.conv.weight.detach().numpy())
        mod = m.bn if m.bn is not None else m.conv
        names = (("bias", "weight", "running_mean", "running_var")
                 if m.bn is not None else ("bias",))
        out += [getattr(mod, n).detach().numpy() for n in names]
    return out


def test_weights_file_jax_to_port(nets, tmp_path):
    spec, params, port_spec, model, _ = nets
    path = str(tmp_path / "jax.weights")
    jax_yolo.save_darknet_weights(spec, params, path, seen=1234)
    loaded, header = port_yolo.load_darknet_weights(port_spec, path, RESO)
    assert header.tolist() == [0, 1, 0, 1234]
    for a, b in zip(_conv_arrays(loaded), _conv_arrays(model)):
        np.testing.assert_array_equal(a, b)


def test_weights_file_port_to_jax(nets, tmp_path):
    spec, params, _, model, _ = nets
    path = str(tmp_path / "port.weights")
    port_yolo.save_darknet_weights(model, path, seen=77)
    loaded, header = jax_yolo.load_darknet_weights(spec, path)
    assert header.tolist() == [0, 1, 0, 77]
    for p, q in zip(params, loaded):
        assert p.keys() == q.keys()
        for k in p:
            np.testing.assert_array_equal(np.asarray(q[k]), np.asarray(p[k]))


def test_uint64_seen_header_and_partial_file(nets, tmp_path):
    """Official release files carry minor=2 and a uint64 `seen`; a
    truncated file fills the leading layers and keeps the rest at init."""
    _, _, port_spec, model, _ = nets
    path = str(tmp_path / "full.weights")
    port_yolo.save_darknet_weights(model, path)
    with open(path, "rb") as f:
        body = f.read()[16:]
    first = port_yolo.conv_layers(model)[0][1]
    n_first = 4 * 32 + first.conv.weight.numel()
    official = str(tmp_path / "official.weights")
    with open(official, "wb") as f:
        f.write(np.array([0, 2, 0], np.int32).tobytes())
        f.write(np.array([2 ** 40], np.uint64).tobytes())
        f.write(body[:4 * n_first + 8])       # first layer and a bit more
    loaded, header = port_yolo.load_darknet_weights(
        port_spec, official, RESO,
        generator=torch.Generator().manual_seed(5))
    assert header.tolist() == [0, 2, 0, 2 ** 40]
    got = port_yolo.conv_layers(loaded)
    np.testing.assert_array_equal(got[0][1].conv.weight.detach().numpy(),
                                  first.conv.weight.detach().numpy())
    fresh = port_yolo.Darknet(port_spec, RESO,
                              torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(
        got[1][1].conv.weight.detach().numpy(),
        port_yolo.conv_layers(fresh)[1][1].conv.weight.detach().numpy())
    with pytest.raises(ValueError):
        port_yolo.load_darknet_weights(port_spec, official, RESO,
                                       allow_partial=False)


def test_other_layer_kinds_raise():
    with pytest.raises(NotImplementedError, match="slice 5"):
        port_yolo.build_spec("[maxpool]\nsize=2\nstride=2\n")
    with pytest.raises(NotImplementedError, match="slice 5"):
        port_yolo.build_spec("[convolutional]\nfilters=4\nsize=1\n"
                             "stride=1\nactivation=mish\n")


def test_init_is_seeded_he_normal():
    spec = port_yolo.build_spec(CFG)
    a = port_yolo.Darknet(spec, RESO, torch.Generator().manual_seed(3))
    b = port_yolo.Darknet(spec, RESO, torch.Generator().manual_seed(3))
    for x, y in zip(_conv_arrays(a), _conv_arrays(b)):
        np.testing.assert_array_equal(x, y)
    w = port_yolo.conv_layers(a)[10][1].conv.weight.detach().numpy()
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(w.std() * np.sqrt(fan_in / 2.0) - 1.0) < 0.05
