"""The PyTorch port's image and box ops against the JAX package
(`betapose_tpu/ops/image.py`, `betapose_tpu/ops/boxes.py`), float32 on the
CPU, atol 1e-5 (the products sum in another order; the weights are the
same)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.ops import boxes as jax_boxes  # noqa: E402
from betapose_tpu.ops import image as jax_image  # noqa: E402
from betapose_tpu_torch.ops import boxes as port_boxes  # noqa: E402
from betapose_tpu_torch.ops import image as port_image  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("shape", [(20, 24, 16, 16), (12, 10, 30, 20)])
def test_resize_bilinear_matmul(antialias, shape):
    h, w, oh, ow = shape
    x = np.random.default_rng(0).random((2, h, w, 3), np.float32)
    ref = jax_image.resize_bilinear_matmul(jnp.asarray(x), oh, ow,
                                           antialias=antialias)
    out = port_image.resize_bilinear_matmul(_t(x), oh, ow,
                                            antialias=antialias)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_letterbox():
    x = np.random.default_rng(1).random((2, 30, 40, 3), np.float32) * 255
    ref = jax_image.letterbox(jnp.asarray(x), 32, 32)
    out = port_image.letterbox(_t(x), 32, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=255 * ATOL)


def _boxes(rng, n, h, w):
    x1 = rng.uniform(-10, w * 0.7, n)
    y1 = rng.uniform(-10, h * 0.7, n)
    bw = rng.uniform(3, w * 0.6, n)
    bh = rng.uniform(3, h * 0.6, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def test_expand_boxes():
    boxes = _boxes(np.random.default_rng(2), 16, 480, 640)
    boxes[0, 2] = boxes[0, 0] + 150          # the width > 100 rate
    ul, br = jax_image.expand_boxes(jnp.asarray(boxes), 480, 640)
    pul, pbr = port_image.expand_boxes(_t(boxes), 480, 640)
    np.testing.assert_array_equal(pul.numpy(), np.asarray(ul))
    np.testing.assert_array_equal(pbr.numpy(), np.asarray(br))


def test_crop_from_dets_matches_per_frame_jax():
    rng = np.random.default_rng(3)
    imgs = rng.random((4, 48, 64, 3), np.float32)
    boxes = _boxes(rng, 4, 48, 64)
    crops, pt1, pt2 = port_image.crop_from_dets(_t(imgs), _t(boxes), 32, 24)
    for b in range(4):
        rc, r1, r2 = jax_image.crop_from_dets(
            jnp.asarray(imgs[b]), jnp.asarray(boxes[b:b + 1]), 32, 24)
        np.testing.assert_allclose(crops[b].numpy(), np.asarray(rc[0]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_array_equal(pt1[b].numpy(), np.asarray(r1[0]))
        np.testing.assert_array_equal(pt2[b].numpy(), np.asarray(r2[0]))


def test_crop_params_match():
    rng = np.random.default_rng(4)
    ul = np.floor(rng.uniform(0, 50, (6, 2))).astype(np.float32)
    br = (ul + np.floor(rng.uniform(5, 80, (6, 2)))).astype(np.float32)
    ref = jax.vmap(lambda u, b: jax_image.crop_box_params(u, b, 64, 48))(
        jnp.asarray(ul), jnp.asarray(br))
    out = port_image.crop_box_params(_t(ul), _t(br), 64, 48)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_transform_box_invert_batch():
    rng = np.random.default_rng(5)
    pt = rng.uniform(0, 16, (3, 7, 2)).astype(np.float32)
    ul = rng.uniform(0, 100, (3, 2)).astype(np.float32)
    br = (ul + rng.uniform(10, 200, (3, 2))).astype(np.float32)
    ref = jax_image.transform_box_invert_batch(
        jnp.asarray(pt), jnp.asarray(ul), jnp.asarray(br), 64, 48, 16, 12)
    out = port_image.transform_box_invert_batch(
        _t(pt), _t(ul), _t(br), 64, 48, 16, 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _predictions(rng, b=3, n=40, nc=2):
    p = rng.random((b, n, 5 + nc)).astype(np.float32)
    p[..., :4] *= 64
    return p


def test_best_box_with_tie_takes_first_row():
    rng = np.random.default_rng(6)
    p = _predictions(rng)
    p[0, :, 5] = 1.0                        # class 0 wins everywhere
    p[0, :, 6] = 0.0
    p[0, 7, 4] = p[0, 21, 4] = 2.0          # exact tie: row 7 must win
    p[1, :, 4] = 0.001                      # nothing passes the threshold
    for conf in (0.01, 0.5):
        ref = jax_boxes.best_box(jnp.asarray(p), conf, 0)
        out = port_boxes.best_box(_t(p), conf, 0)
        for k in ("boxes", "obj_score", "cls_score", "valid"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    sel = port_boxes.best_box(_t(p), 0.01, 0)
    np.testing.assert_array_equal(
        sel["boxes"][0].numpy(),
        port_boxes.xywh_to_xyxy(_t(p[0, 7, :4])).numpy())
    assert not bool(sel["valid"][1])


def test_bbox_iou_and_xyxy():
    rng = np.random.default_rng(7)
    a = _boxes(rng, 10, 100, 100)
    b = _boxes(rng, 10, 100, 100)
    np.testing.assert_allclose(
        port_boxes.bbox_iou(_t(a)[:, None], _t(b)[None]).numpy(),
        np.asarray(jax_boxes.bbox_iou(jnp.asarray(a)[:, None],
                                      jnp.asarray(b)[None])),
        rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        port_boxes.xywh_to_xyxy(_t(a)).numpy(),
        np.asarray(jax_boxes.xywh_to_xyxy(jnp.asarray(a))))


@pytest.mark.parametrize("fn", ["rescale_boxes", "unletterbox_boxes"])
def test_box_rescales(fn):
    boxes = _boxes(np.random.default_rng(8), 5, 416, 416)
    ref = getattr(jax_boxes, fn)(jnp.asarray(boxes), 640, 480, 416)
    out = getattr(port_boxes, fn)(_t(boxes), 640, 480, 416)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)
