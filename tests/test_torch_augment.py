"""The PyTorch port's KPD training augmentation against the JAX package
(`betapose_tpu/train/augment.py`, `ops/heatmap.py`, `ops/image.py`) on the
CPU, at a small size: 96x128 frames, 16 keypoints, 64x32 crops -> 16x8
heatmaps.

- `draw_gaussian_batch` is JAX's, fractional points below 3 sigma (the
  short window) and points off the map included: the same pixels are set,
  each to within one float32 ulp (XLA's CPU `exp` is not correctly
  rounded: it is 1 ulp off the float64 value at 4 of the 40 arguments a
  sigma-1 window takes, torch's at none, so no port can match it bit for
  bit; both are 1 at the centre);
- `_bilinear_gather`, `_rotate_image`, `rotate_image_shear` and
  `rotate_points` are within 1e-5;
- `augment_batch` in train mode with DPG, fed the draws `jax.random`
  derives for the JAX package (`split(key, B)`, then `split(k, 12)` per
  sample), gives inputs within 1e-5 of JAX run op by op
  (`jax.disable_jit`: compiled, XLA fuses the crop's weight arithmetic,
  which moves single pixels of these uniform-noise frames by up to 1.1e-5
  from its own op-by-op result) and labels equal in the sense above
  (no rotated point lies within 1e-4 of a .5 rounding boundary, where
  float32 sin/cos could round it either way); keys are chosen so
  that both DPG box branches, all 9 half-crop choices, flips and
  rotations occur;
- eval mode matches JAX and reads no draw but the box padding's;
- the annotation h5 round-trips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.ops import heatmap as jax_hm  # noqa: E402
from betapose_tpu.ops import image as jax_image  # noqa: E402
from betapose_tpu.train import augment as jax_aug  # noqa: E402
from betapose_tpu_torch.ops import heatmap as port_hm  # noqa: E402
from betapose_tpu_torch.ops import image as port_image  # noqa: E402
from betapose_tpu_torch.train import augment as port_aug  # noqa: E402

H, W, K = 96, 128, 16
CFG = port_aug.AugmentConfig(inp_h=64, inp_w=32, out_h=16, out_w=8,
                             add_dpg=True, train=True)
JCFG = jax_aug.AugmentConfig(**vars(CFG))


def jax_draws(key):
    """The draws of the JAX `_augment_one` for its key, as it makes them."""
    k = jax.random.split(key, 12)
    u = jax.random.uniform
    return {"jit3": u(k[0], (3,), minval=0.7, maxval=1.3),
            "rate": u(k[1], minval=CFG.scale_min, maxval=CFG.scale_max),
            "patch_scale": u(k[2]),
            "patch_u": jnp.stack([u(k[3]), u(k[4])]),
            "gauss": jax.random.normal(k[5], (4,)),
            "switch": u(k[6]), "flip_u": u(k[7]),
            "rot_n": jax.random.normal(k[8]), "rot_u": u(k[9])}


_batch_draws = jax.jit(jax.vmap(jax_draws))


def assert_labels_equal(got, ref):
    """The same pixels set, each within one float32 ulp of exp."""
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -23, atol=0)


def to_port(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def frames(n, seed=0):
    """Frames, boxes around a central region, 16 keypoints clustered in
    the box's middle (so the DPG half-crops see more than 13), and a
    visibility mask."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    x0 = rng.uniform(15, 35, n)
    y0 = rng.uniform(10, 25, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(50, 70, n),
                      y0 + rng.uniform(45, 60, n)], 1).astype(np.float32)
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    half = (boxes[:, 2:] - boxes[:, :2]) / 4
    parts = (c[:, None] + rng.uniform(-1, 1, (n, K, 2)) * half[:, None]
             ).astype(np.float32)
    kp_vis = (rng.uniform(0, 1, (n, K)) > 0.1).astype(np.float32)
    return imgs, boxes, parts, kp_vis


def test_draw_gaussian_is_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-6, 20, (3, 12, 2)).astype(np.float32)
    # below 3 sigma (short window), integers, off the map on every side
    pts[0, :6] = [[0.4, 1.3], [2.7, 0.2], [-2.5, 5.0], [5.0, -2.6],
                  [3.0, 3.0], [-0.5, -0.5]]
    pts[1, :4] = [[-10.0, 4.0], [30.0, 4.0], [4.0, -9.0], [4.0, 40.0]]
    for sigma in (1, 2):
        ref = np.asarray(jax_hm.draw_gaussian_batch(
            jnp.asarray(pts), 20, 16, sigma=sigma))
        got = port_hm.draw_gaussian_batch(torch.from_numpy(pts), 20, 16,
                                          sigma=sigma).numpy()
        assert got.dtype == np.float32
        assert_labels_equal(got, ref)
        assert (got == 1).sum() == (ref == 1).sum() > 0
        assert (ref[1, :4] == 0).all()
        assert 0 < (ref[0, 0] > 0).sum() < (6 * sigma + 1) ** 2


def test_bilinear_gather_and_rotations():
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (3, 20, 14, 3)).astype(np.float32)
    ys = rng.uniform(-3, 23, (3, 9, 11)).astype(np.float32)
    xs = rng.uniform(-3, 17, (3, 9, 11)).astype(np.float32)
    ref = np.stack([jax_image._bilinear_gather(img[i], ys[i], xs[i])
                    for i in range(3)])
    got = port_image._bilinear_gather(*map(torch.from_numpy, (img, ys, xs)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

    deg = np.asarray([-57.0, 0.0, 23.5], np.float32)
    timg, tdeg = torch.from_numpy(img), torch.from_numpy(deg)
    for jfn, pfn in ((jax_aug._rotate_image, port_aug._rotate_image),
                     (jax_aug.rotate_image_shear,
                      port_aug.rotate_image_shear)):
        ref = np.stack([jfn(img[i], deg[i]) for i in range(3)])
        np.testing.assert_allclose(pfn(timg, tdeg).numpy(), ref,
                                   atol=1e-5, rtol=0)
    pts = rng.uniform(-2, 18, (3, 7, 2)).astype(np.float32)
    ref = np.stack([jax_aug.rotate_points(pts[i], deg[i], 16, 8)
                    for i in range(3)])
    got = port_aug.rotate_points(torch.from_numpy(pts), tdeg, 16, 8)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def choose_keys():
    """Per-sample keys covering both DPG box branches (patch_scale above
    and below 0.85), all 9 half-crop choices (switch in each interval of
    HALF_CROP), flips and rotations."""
    keys = jax.random.split(jax.random.PRNGKey(7), 400)
    d = _batch_draws(keys)
    ps, sw = np.asarray(d["patch_scale"]), np.asarray(d["switch"])
    edges = list(port_aug.HALF_CROP[:-1]) + [0.0]
    chosen = list(np.flatnonzero(ps > 0.85)[:3])
    for i, lo in enumerate(edges):
        hi = 1.0 if i == 0 else edges[i - 1]
        hit = np.flatnonzero((ps <= 0.85) & (sw > lo) & (sw <= hi))
        chosen += list(hit[:2])
    return keys[np.asarray(chosen)]


@pytest.fixture(scope="module")
def dpg_case():
    keys = choose_keys()
    n = len(keys)
    imgs, boxes, parts, kp_vis = frames(n)
    with jax.disable_jit():
        inps, labels, masks = jax.vmap(
            lambda k, i, b, p, v: jax_aug._augment_one(k, i, b, p, JCFG, v)
        )(keys, imgs, boxes, parts, kp_vis)
    return (keys, (imgs, boxes, parts, kp_vis),
            tuple(map(np.asarray, (inps, labels, masks))))


def near_half(cfg, imgs, boxes, parts, d):
    """Keypoints whose rotated heatmap point lies within 1e-4 of a .5
    rounding boundary: there float32 sin/cos of either package may round
    it either way."""
    t = torch.from_numpy
    ul, br, _ = port_aug.crop_boxes(t(boxes), t(parts), d, cfg, H, W)
    pts = port_aug.transform_box(t(parts), ul, br, cfg.inp_h, cfg.inp_w,
                                 cfg.out_h, cfg.out_w)
    flip = (d["flip_u"] < 0.5)[:, None]
    pts = torch.stack([torch.where(flip, cfg.out_w - 1.0 - pts[..., 0],
                                   pts[..., 0]), pts[..., 1]], -1)
    r = (d["rot_n"] * cfg.rotate).clamp(-2 * cfg.rotate, 2 * cfg.rotate)
    r = torch.where(d["rot_u"] < 0.6, 0.0, r)
    rot = port_aug.rotate_points(pts, r, cfg.out_h, cfg.out_w)
    frac = (rot - torch.floor(rot)).numpy()
    return (np.abs(frac - 0.5) < 1e-4).any(-1)


def test_augment_train_dpg_matches_jax(dpg_case):
    keys, (imgs, boxes, parts, kp_vis), (inps, labels, _) = dpg_case
    d = to_port(_batch_draws(keys))
    t = torch.from_numpy
    _, _, variant = port_aug.crop_boxes(t(boxes), t(parts), d, CFG, H, W)
    # every branch taken: patch and gauss boxes, each half-crop and none,
    # flips both ways, rotations and none
    assert (d["patch_scale"] > 0.85).any() and (d["patch_scale"] <= 0.85).any()
    assert set(variant.tolist()) == set(range(9))
    assert (d["flip_u"] < 0.5).any() and (d["flip_u"] >= 0.5).any()
    assert (d["rot_u"] >= 0.6).any() and (d["rot_u"] < 0.6).any()

    out = port_aug.augment_batch(t(imgs), t(boxes), t(parts), CFG,
                                 draws=d, kp_vis=t(kp_vis))
    np.testing.assert_allclose(out["inps"].numpy(), inps, atol=1e-5, rtol=0)
    ref = labels.transpose(0, 3, 1, 2)              # NHWC -> [B,K,oH,oW]
    boundary = near_half(CFG, imgs, boxes, parts, d)
    assert boundary.sum() == 0
    assert_labels_equal(out["labels"].numpy(), ref)
    assert (ref > 0).any(axis=(2, 3)).sum() > len(keys) * K // 4
    np.testing.assert_array_equal(out["set_mask"].numpy(), 1.0)


def test_augment_batch_key_split_matches_jax():
    """augment_batch(key, ...) of the JAX package: per-sample keys from
    split(key, B), the draws from split(k, 12)."""
    imgs, boxes, parts, _ = frames(6, seed=3)
    cfg = port_aug.AugmentConfig(inp_h=64, inp_w=32, out_h=16, out_w=8,
                                 add_dpg=False, train=True)
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        ref = jax_aug.augment_batch(
            key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(parts),
            jax_aug.AugmentConfig(**vars(cfg)))
    d = to_port(_batch_draws(jax.random.split(key, 6)))
    t = torch.from_numpy
    out = port_aug.augment_batch(t(imgs), t(boxes), t(parts), cfg, draws=d)
    np.testing.assert_allclose(out["inps"].numpy(), np.asarray(ref["inps"]),
                               atol=1e-5, rtol=0)
    assert near_half(cfg, imgs, boxes, parts, d).sum() == 0
    assert_labels_equal(out["labels"].numpy(),
                        np.asarray(ref["labels"]).transpose(0, 3, 1, 2))


def test_augment_eval_matches_jax_and_reads_only_rate():
    imgs, boxes, parts, _ = frames(4, seed=5)
    cfg = port_aug.AugmentConfig(inp_h=64, inp_w=32, out_h=16, out_w=8,
                                 add_dpg=True, train=False)
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        ref = jax_aug.augment_batch(
            key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(parts),
            jax_aug.AugmentConfig(**vars(cfg)))
    d = to_port(_batch_draws(jax.random.split(key, 4)))
    t = torch.from_numpy
    out = port_aug.augment_batch(t(imgs), t(boxes), t(parts), cfg, draws=d)
    np.testing.assert_allclose(out["inps"].numpy(), np.asarray(ref["inps"]),
                               atol=1e-5, rtol=0)
    assert_labels_equal(out["labels"].numpy(),
                        np.asarray(ref["labels"]).transpose(0, 3, 1, 2))
    # every draw but the padding rate changed: nothing else moves
    other = {k: (v if k == "rate" else torch.rand_like(v))
             for k, v in d.items()}
    again = port_aug.augment_batch(t(imgs), t(boxes), t(parts), cfg,
                                   draws=other)
    for k in out:
        assert torch.equal(out[k], again[k])


def test_augment_generator_draws_are_seeded():
    imgs, boxes, parts, _ = frames(3, seed=6)
    t = torch.from_numpy
    outs = [port_aug.augment_batch(
        t(imgs), t(boxes), t(parts), CFG,
        torch.Generator().manual_seed(seed)) for seed in (1, 1, 2)]
    assert outs[0]["inps"].shape == (3, 64, 32, 3)
    assert outs[0]["labels"].shape == (3, K, 16, 8)
    assert torch.equal(outs[0]["inps"], outs[1]["inps"])
    assert not torch.equal(outs[0]["inps"], outs[2]["inps"])
    d = port_aug.draw_random(1000, CFG, torch.Generator().manual_seed(0))
    assert set(d) == set(port_aug.DRAWS)
    for k, shape in port_aug.DRAWS.items():
        assert d[k].shape == (1000, *shape)
    assert 0.7 <= d["jit3"].min() and d["jit3"].max() < 1.3
    assert 0.2 <= d["rate"].min() and d["rate"].max() < 0.3


def test_annot_h5_round_trip(tmp_path):
    pytest.importorskip("h5py")
    from betapose_tpu.data import annot as jax_annot
    from betapose_tpu_torch.data import annot as port_annot
    names = ["000000000001.png", "a/b.png"]
    boxes = np.asarray([[[1.0, 2.0, 30.0, 40.0]], [[5.0, 6.0, 7.0, 8.0]]])
    parts = np.arange(2 * 3 * 2, dtype=np.float64).reshape(2, 3, 2)
    path = str(tmp_path / "annot.h5")
    port_annot.write_annot_h5(path, names, boxes, parts)
    got = port_annot.read_annot_h5(path)
    ref = jax_annot.read_annot_h5(path)
    assert got[0] == names == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], boxes[:, 0])
    assert port_annot.decode_imgname(
        port_annot.encode_imgname("x.png", 8)) == "x.png"
