"""The port's space-to-depth stem (`betapose_tpu_torch/models/stem_s2d.py`)
against the JAX package's (`betapose_tpu/models/stem_s2d.py`), float32 on
the CPU.

- The packed weights equal JAX's bit for bit: every slot receives at most
  one original value, added to zeros.
- The rewrites compute the plain convs' function: the stem and the
  stride-2 convs to rtol 1e-4 / atol 1e-5, FastPose to rtol 1e-3 (a deep
  stack after the rewritten stem), the full YOLOv3 within the JAX test's
  statistical bar (a random 75-layer net amplifies 1e-6 summation noise
  chaotically, so a few entries may drift).
- `PosePipeline(s2d_stem=True)` gives the plain stem's boxes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.models import kpd as jax_kpd  # noqa: E402
from betapose_tpu.models import stem_s2d as jax_s2d  # noqa: E402
from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu.models.darknet_cfg import make_yolov3_cfg  # noqa: E402
from betapose_tpu.tools import probe_s2d_stage as jax_stage  # noqa: E402
from betapose_tpu_torch.eval import pipeline as port_pipe  # noqa: E402
from betapose_tpu_torch.models import kpd as port_kpd  # noqa: E402
from betapose_tpu_torch.models import stem_s2d as port_s2d  # noqa: E402
from betapose_tpu_torch.models import yolov3 as port_yolo  # noqa: E402
from betapose_tpu_torch.tools import (  # noqa: E402
    probe_s2d_stage as port_stage)
from betapose_tpu_torch.tools.profile_pipeline import (  # noqa: E402
    calibrate_heads)
from tests.test_torch_kpd import random_kpd_params  # noqa: E402


def _np_normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _stem_params():
    """The JAX test's stem: conv 3x3/1 3->8 and conv 3x3/2 8->16, HWIO."""
    rng = np.random.default_rng(0)

    def draw(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return [{"w": draw(3, 3, 3, 8), "b": draw(8)},
            {"w": draw(3, 3, 8, 16), "b": draw(16)}]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- packing: bitwise --------------------------------------------------


@pytest.mark.parametrize("name,shape", [
    ("pack_conv1_weights", (3, 3, 3, 8)),
    ("pack_conv1_weights", (3, 3, 8, 5)),
    ("pack_conv2_weights", (3, 3, 8, 16)),
    ("pack_conv2_weights", (3, 3, 3, 4))])
def test_packed_weights_bitwise_equal_jax(name, shape):
    w = _np_normal(1, shape)
    ref = np.asarray(getattr(jax_s2d, name)(jnp.asarray(w)))
    got = getattr(port_s2d, name)(_t(w)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(7, 7, 3, 8), (3, 3, 4, 6), (5, 5, 2, 3)])
def test_packed_stride2_weights_bitwise_equal_jax(shape):
    w = _np_normal(2, shape)
    ref, ref_pads = jax_s2d.pack_stride2_conv_weights(jnp.asarray(w))
    got, pads = port_s2d.pack_stride2_conv_weights(_t(w))
    assert pads == ref_pads
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_packed_bias_equals_jax():
    b = _np_normal(3, (8,))
    np.testing.assert_array_equal(
        port_s2d.pack_conv1_bias(_t(b)).numpy(),
        np.asarray(jax_s2d.pack_conv1_bias(jnp.asarray(b))))


# ---- space_to_depth2 ------------------------------------------------------


def test_space_to_depth_layout():
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    out = port_s2d.space_to_depth2(x)[0].numpy()
    # channel 0 = phase (0,0): rows 0/2, cols 0/2
    np.testing.assert_array_equal(out[:, :, 0], [[0, 2], [8, 10]])
    # channel 3 = phase (1,1)
    np.testing.assert_array_equal(out[:, :, 3], [[5, 7], [13, 15]])


def test_space_to_depth_equals_jax():
    x = _np_normal(4, (2, 6, 8, 3))
    np.testing.assert_array_equal(
        port_s2d.space_to_depth2(_t(x)).numpy(),
        np.asarray(jax_s2d.space_to_depth2(jnp.asarray(x))))


# ---- the stem ------------------------------------------------------------


def _stem_reference(p, x):
    """conv1 + leaky + conv2/2 + leaky, the JAX test's reference."""
    y = jax.lax.conv_general_dilated(
        x, p[0]["w"], (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p[0]["b"]
    y = jnp.where(y > 0, y, 0.1 * y)
    z = jax.lax.conv_general_dilated(
        y, p[1]["w"], (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p[1]["b"]
    return jnp.where(z > 0, z, 0.1 * z)


def test_stem_forward_matches_jax():
    p = _stem_params()
    x = _np_normal(1, (2, 32, 48, 3))
    packed = {"w1": port_s2d.pack_conv1_weights(_t(p[0]["w"])),
              "b1": port_s2d.pack_conv1_bias(_t(p[0]["b"])),
              "w2": port_s2d.pack_conv2_weights(_t(p[1]["w"])),
              "b2": _t(p[1]["b"])}
    got = port_s2d.stem_forward(packed, _t(x)).numpy()
    jp = [{k: jnp.asarray(v) for k, v in q.items()} for q in p]
    golden = np.asarray(_stem_reference(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-5)
    jax_fast = np.asarray(jax_s2d.stem_forward(
        jax_s2d.pack_stem_params(jp), jnp.asarray(x)))
    np.testing.assert_allclose(got, jax_fast, rtol=1e-4, atol=1e-5)


# ---- the full network ------------------------------------------------------


@pytest.fixture(scope="module")
def yolo128():
    """YOLOv3 (1 class) at 128 with folded params drawn with numpy, on
    both sides."""
    cfg = make_yolov3_cfg(num_classes=1, width=128, height=128)
    spec = jax_yolo.build_spec(cfg)
    rng = np.random.default_rng(0)
    params = [
        {"w": (rng.standard_normal((l.size, l.size, l.in_channels,
                                    l.out_channels))
               * np.sqrt(2.0 / (l.size ** 2 * l.in_channels))
               ).astype(np.float32),
         "b": rng.normal(0, 0.1, l.out_channels).astype(np.float32)}
        if l.kind == "conv" else {} for l in spec.layers]
    model = port_yolo.params_from_jax(port_yolo.build_spec(cfg), params, 128)
    x = _np_normal(2, (1, 128, 128, 3))
    return spec, params, model, x


def _statistical_bar(fast, plain):
    for a, b in zip(fast, plain):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        bad = np.abs(a - b) > (1e-3 + 1e-2 * np.abs(b))
        assert bad.mean() < 0.005, bad.mean()


def test_full_network_equivalence(yolo128):
    spec, params, model, x = yolo128
    assert port_s2d.stem_applicable(model.spec)
    with torch.no_grad():
        plain = [h.numpy() for h in model(_t(x), decode=False)]
        fast = [h.numpy() for h in port_s2d.forward_with_s2d_stem(
            model, _t(x), decode=False)]
    _statistical_bar(fast, plain)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    jax_fast = jax.jit(lambda p, v: jax_s2d.forward_with_s2d_stem(
        spec, p, v, 128, decode=False))(jp, jnp.asarray(x))
    _statistical_bar(fast, jax_fast)


def test_stem_level_matches_plain_layers(yolo128):
    _, _, model, x = yolo128
    with torch.no_grad():
        xn = _t(x).permute(0, 3, 1, 2)
        ref = model.layers[1](model.layers[0](xn)).permute(0, 2, 3, 1)
        got = port_s2d.stem_forward(port_s2d.pack_stem_params(model), _t(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-5)


def test_unfolded_or_other_stems_take_the_plain_forward(yolo128):
    _, _, model, x = yolo128
    unfolded = port_yolo.Darknet(model.spec, 128,
                                 torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = port_s2d.forward_with_s2d_stem(unfolded, _t(x))
        b = unfolded(_t(x))
    assert torch.equal(a, b)


def test_packed_stem_is_rebuilt_when_weights_change(yolo128):
    _, _, model, x = yolo128
    import copy
    m = copy.deepcopy(model)
    with torch.no_grad():
        before = port_s2d.forward_with_s2d_stem(m, _t(x), decode=False)[0]
        m.layers[0].conv.weight.mul_(2.0)
        after = port_s2d.forward_with_s2d_stem(m, _t(x), decode=False)[0]
        plain = m(_t(x), decode=False)[0]
    assert not torch.equal(before, after)
    _statistical_bar([after.numpy()], [plain.numpy()])


# ---- stride-2 rewrites and FastPose ---------------------------------------


@pytest.mark.parametrize("xs,ws,pad", [((2, 32, 48, 3), (7, 7, 3, 8), 3),
                                       ((1, 16, 16, 4), (3, 3, 4, 6), 1)])
def test_conv_stride2_via_s2d_matches_jax(xs, ws, pad):
    x = _np_normal(0, xs)
    w = _np_normal(1, ws, 0.1)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = port_s2d.conv_stride2_via_s2d(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_fastpose_s2d_stem_matches_jax():
    params = random_kpd_params(4, "resnet50", 0)
    model = port_kpd.FastPose(4, "resnet50")
    model.load_state_dict(port_kpd.state_dict_from_jax(params))
    x = _np_normal(2, (1, 64, 32, 3))
    ref = np.asarray(jax.jit(lambda p, v: jax_kpd.forward(
        p, v, s2d_stem=True))(params, jnp.asarray(x)))       # [B,H,W,K]
    with torch.no_grad():
        got = model(_t(x), s2d_stem=True).permute(0, 2, 3, 1).numpy()
        plain = model(_t(x)).permute(0, 2, 3, 1).numpy()
        folded = port_kpd.fold_bn(model)(_t(x), s2d_stem=True)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale)
    np.testing.assert_allclose(got, plain, rtol=1e-3, atol=1e-4 * scale)
    np.testing.assert_allclose(folded.permute(0, 2, 3, 1).numpy(), plain,
                               rtol=1e-3, atol=1e-4 * scale)


def test_stage_rewrite_matches_jax():
    """probe_s2d_stage's exact two-block rewrite: grouped 1x1s + packed 3x3
    in the s2d domain against the plain stage."""
    rng = np.random.default_rng(0)
    c = 16
    x = rng.standard_normal((2, 12, 12, c)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in
          ((1, 1, c, c // 2), (3, 3, c // 2, c), (1, 1, c, c // 2),
           (3, 3, c // 2, c))]
    tx, tws = _t(x), [_t(w) for w in ws]
    with torch.no_grad():
        ref = port_s2d.space_to_depth2(port_stage.stage_normal(tx, *tws))
        got = port_stage.stage_s2d(port_s2d.space_to_depth2(tx), *tws)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    jws = [jnp.asarray(w) for w in ws]
    jax_got = np.asarray(jax_stage.stage_s2d(
        jax_s2d.space_to_depth2(jnp.asarray(x)), *jws))
    np.testing.assert_allclose(got.numpy(), jax_got, rtol=1e-4, atol=1e-5)


# ---- the pipeline ----------------------------------------------------------


def test_pipeline_s2d_stem_matches_plain_stem(yolo128):
    """PosePipeline at reso 64 (full YOLOv3, FastPose resnet50) with the s2d
    stem against the plain stem, same networks and frames."""
    _, params, _, _ = yolo128
    cfg = make_yolov3_cfg(num_classes=1, width=64, height=64)
    yolo = port_yolo.params_from_jax(port_yolo.build_spec(cfg), params, 64)
    frames = np.random.default_rng(5).integers(0, 256, (2, 48, 64, 3),
                                               dtype=np.uint8)
    with torch.no_grad():
        x = torch.nn.functional.interpolate(
            torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255.0,
            size=(64, 64)).permute(0, 2, 3, 1)
    calibrate_heads(yolo, x)
    kpd = port_kpd.FastPose(6, "resnet50", torch.Generator().manual_seed(1))
    kp3d = _np_normal(6, (6, 3), 0.05)
    cam = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]])
    base = port_pipe.PipelineConfig(
        reso=64, inp_h=64, inp_w=32, out_h=16, out_w=8, n_kp=6,
        left_keypoints=6, compute_dtype="float32", confidence=0.0)
    outs = {}
    for s2d in (False, True):
        pipe = port_pipe.PosePipeline(
            yolo, kpd, kp3d, cam, dataclasses.replace(base, s2d_stem=s2d),
            device="cpu")
        outs[s2d] = pipe(frames)
    assert torch.equal(outs[True]["det_valid"], outs[False]["det_valid"])
    np.testing.assert_allclose(outs[True]["boxes"].numpy(),
                               outs[False]["boxes"].numpy(), atol=1e-3)
    np.testing.assert_allclose(outs[True]["keypoints"].numpy(),
                               outs[False]["keypoints"].numpy(), atol=1e-2)
    for v in outs[True].values():
        assert torch.isfinite(v.float()).all()
