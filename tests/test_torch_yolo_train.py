"""The PyTorch port's YOLOv3 training (`betapose_tpu_torch/train/
yolo_loss.py`, `yolo_train.py`, the train mode of `models/yolov3.py`)
against the JAX package's (`betapose_tpu/train/yolo_loss.py`,
`yolo_train.py`) on the CPU, float32 on both sides (XLA's CPU ignores the
bf16 precision setting):

- `head_loss` over the cases of tests/test_yolo_train.py (TestHeadLoss,
  TestCollisionSemantics, TestFocalLoss: padding, an out-of-range class,
  an anchor outside the head's mask, the ignore mask, 2- and 3-way
  collisions with a duplicated class, two frames), each with focal off
  and on: the loss within 1e-5 relative, d(loss)/d(raw) within 1e-5 of
  max|grad|, the metrics within 1e-5 relative;
- `lr_schedule` at burn-in, at the step boundaries and past them; the
  optimizer against optax's masked chain over 5 steps within 1e-7, conv
  biases and batch-norm parameters not decayed; `fast_forward_opt_state`
  resumes mid-curve;
- `crop_jitter`, `distort_hsv` and `augment_detection_batch` fed the
  draws `jax.random` gives the JAX package: images within 1e-5, boxes
  within 1e-6;
- darknet's train-mode batch norm (batch mean, biased variance, rolling
  0.99/0.01) against the JAX `_conv_layer` and `apply_bn_updates`;
- three float32 train steps of a two-head net (shortcut, route, upsample,
  masks split across heads in the cfg's large-first order, so that the
  canonical anchor order matters) from the same params: the loss within
  1e-4 relative, parameters within 1e-3 of the largest update, running
  statistics within 1e-5 of each one's largest;
- the port alone overfits six planted boxes (avg_iou > 0.7), as the JAX
  package's TestConvergence does at more steps.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu.train import yolo_loss as jax_loss  # noqa: E402
from betapose_tpu.train import yolo_train as jax_train  # noqa: E402
from betapose_tpu_torch.models import yolov3 as port_yolo  # noqa: E402
from betapose_tpu_torch.train import yolo_loss as port_loss  # noqa: E402
from betapose_tpu_torch.train import yolo_train as port_train  # noqa: E402


# ---------------------------------------------------------------------------
# head_loss
# ---------------------------------------------------------------------------

A3 = [(10, 13), (16, 30), (33, 23)]
A2 = [(8.0, 8.0), (16.0, 16.0)]


def _truths(rows, b=1, t=4):
    tr = np.zeros((b, t, 5), np.float32)
    for (bi, ti), row in rows.items():
        tr[bi, ti] = row
    return tr


def _raw(seed, b, gs, na, nc, scale):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, gs, gs, na * (5 + nc))) * scale
            ).astype(np.float32)


# (raw, anchors, all_anchors, nc, net, truths) per case of the JAX tests
HEAD_CASES = {
    "single_gt": lambda: (_raw(0, 1, 8, 3, 1, 0.01), A3, A3, 1, 64,
                          _truths({(0, 0): [0.55, 0.30, 16 / 64, 30 / 64,
                                            0]})),
    "anchor_not_in_mask": lambda: (
        _raw(1, 1, 8, 1, 1, 0.01), [(10, 13)], [(10, 13), (116, 90)], 1, 64,
        _truths({(0, 0): [0.5, 0.5, 0.9, 0.9, 0]})),
    "out_of_range_class": lambda: (
        _raw(7, 1, 8, 3, 2, 0.01), A3, A3, 2, 64,
        _truths({(0, 0): [0.55, 0.30, 16 / 64, 30 / 64, 1],
                 (0, 1): [0.25, 0.70, 10 / 64, 13 / 64, 2],
                 (0, 2): [0.65, 0.40, 12 / 64, 20 / 64, 7]})),
    "ignore_thresh": lambda: (
        np.zeros((1, 4, 4, 6), np.float32), [(16, 16)], [(16, 16)], 1, 64,
        _truths({(0, 0): [2.5 / 4, 1.5 / 4, 16 / 64, 16 / 64, 0]}, t=2)),
    "no_collision": lambda: (
        _raw(0, 1, 4, 2, 3, 0.5), A2, A2, 3, 32,
        _truths({(0, 0): [0.3, 0.3, 8 / 32, 8 / 32, 0],
                 (0, 1): [0.8, 0.8, 17 / 32, 15 / 32, 2]})),
    "two_same_site_other_class": lambda: (
        _raw(0, 1, 4, 2, 3, 0.5), A2, A2, 3, 32,
        _truths({(0, 0): [0.30, 0.30, 8 / 32, 8 / 32, 0],
                 (0, 1): [0.33, 0.34, 9 / 32, 8.5 / 32, 1]})),
    "three_with_class_dup": lambda: (
        _raw(0, 1, 4, 2, 3, 0.5), A2, A2, 3, 32,
        _truths({(0, 0): [0.30, 0.30, 8 / 32, 8 / 32, 0],
                 (0, 1): [0.33, 0.34, 9 / 32, 8.5 / 32, 1],
                 (0, 2): [0.31, 0.32, 7.5 / 32, 8 / 32, 0]})),
    "same_class_twice": lambda: (
        _raw(0, 1, 4, 2, 3, 0.5), A2, A2, 3, 32,
        _truths({(0, 0): [0.30, 0.30, 8 / 32, 8 / 32, 2],
                 (0, 1): [0.33, 0.34, 9 / 32, 8.5 / 32, 2]})),
    "across_batch": lambda: (
        _raw(3, 2, 4, 2, 3, 0.5), A2, A2, 3, 32,
        _truths({(0, 0): [0.30, 0.30, 8 / 32, 8 / 32, 0],
                 (1, 0): [0.31, 0.32, 8 / 32, 8 / 32, 1],
                 (1, 2): [0.70, 0.20, 15 / 32, 17 / 32, 2]}, b=2)),
}


@pytest.mark.parametrize("focal", [False, True], ids=["plain", "focal"])
@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_head_loss_matches_jax(case, focal):
    raw, anchors, all_anchors, nc, net, truths = HEAD_CASES[case]()

    def f(r):
        return jax_loss.head_loss(r, anchors, all_anchors, nc, net, net,
                                  jnp.asarray(truths), focal=focal)

    (l_j, m_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(raw))
    r = torch.from_numpy(raw).requires_grad_()
    l_p, m_p = port_loss.head_loss(r, anchors, all_anchors, nc, net, net,
                                   torch.from_numpy(truths), focal=focal)
    l_p.backward()
    np.testing.assert_allclose(l_p.item(), float(l_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(r.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
    assert set(m_p) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_p[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_canonical_anchor_order_and_cfg_knobs():
    spec = port_yolo.build_spec(TWO_HEAD_CFG)
    heads = [spec.layers[i] for i in spec.yolo_idxs]
    assert [h.ignore_thresh for h in heads] == [0.6, 0.7]
    assert [h.focal_loss for h in heads] == [True, False]
    jspec = jax_yolo.build_spec(TWO_HEAD_CFG)
    jheads = [jspec.layers[i] for i in jspec.yolo_idxs]
    order = port_loss._canonical_anchor_order(heads)
    assert order == jax_loss._canonical_anchor_order(jheads)
    assert order[0] == (6, 8) and [h.anchors for h in heads][0][0] != (6, 8)
    with pytest.raises(NotImplementedError, match="slice 5"):
        port_yolo.build_spec("[region]\nanchors=1,1\nclasses=1\nnum=1\n")


# ---------------------------------------------------------------------------
# lr_schedule and the optimizer
# ---------------------------------------------------------------------------

SCHED = dict(lr=1e-3, burn_in=100, steps=(1000, 2000), scales=(0.1, 0.5))


@pytest.mark.parametrize("burn_in", [100, 0])
def test_lr_schedule_matches_jax(burn_in):
    cfg = dict(SCHED, burn_in=burn_in)
    lr_j = jax_train.lr_schedule(jax_train.YoloTrainConfig(**cfg))
    lr_p = port_train.lr_schedule(port_train.YoloTrainConfig(**cfg))
    for step in (0, 1, 37, 50, 99, 100, 101, 999, 1000, 1001, 1500, 2000,
                 2001, 2500, 10 ** 6):
        got, ref = lr_p(step), float(lr_j(step))
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(float(got), ref, rtol=1e-6, atol=0,
                                   err_msg=str(step))
    assert float(lr_p(0)) == (0.0 if burn_in else np.float32(1e-3))


def port_cfg(cfg):
    """The port's config with the JAX config's values."""
    return port_train.YoloTrainConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(port_train.YoloTrainConfig)})


def _tiny_params(seed=0):
    spec = port_yolo.build_spec(TINY_CFG)
    return spec, jax_yolo.init_params(jax.random.PRNGKey(seed),
                                      jax_yolo.build_spec(TINY_CFG))


def _grad_lists(params, seed, n):
    """n gradient lists in the JAX layout (zero for the running stats,
    which take no gradient), and the port module that holds each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append([{k: (np.zeros_like(np.asarray(v))
                         if k in ("bn_mean", "bn_var") else
                         rng.normal(0, 0.1, np.shape(v)).astype(np.float32))
                     for k, v in p.items()} for p in params])
    return out


def _run_optax(cfg, params, grads, start=0):
    tx = jax_train.make_optimizer(cfg)
    st = jax_train.fast_forward_opt_state(tx.init(params), start)

    for g in grads:          # op by op: no fused multiply-adds
        upd, st = tx.update(g, st, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    return params


def _run_port(spec, cfg, params, grads, start=0):
    model = port_yolo.params_from_jax(spec, params)
    opt = port_train.make_optimizer(model, port_cfg(cfg))
    port_train.fast_forward_opt_state(opt, start)
    for g in grads:
        holder = port_yolo.params_from_jax(spec, g)
        for p, h in zip(model.parameters(), holder.parameters()):
            p.grad = h.detach().clone()
        opt.step()
    return model, opt


def _flat(layers):
    return {f"{i}/{k}": np.asarray(v) for i, p in enumerate(layers)
            for k, v in p.items()}


@pytest.mark.parametrize("start", [0, 3])
def test_optimizer_matches_optax(start):
    spec, params = _tiny_params()
    cfg = jax_train.YoloTrainConfig(lr=0.1, burn_in=4, steps=(5,),
                                    scales=(0.1,), momentum=0.9, decay=0.05)
    grads = _grad_lists(params, 1, 5)
    ref = _flat(_run_optax(cfg, params, grads, start))
    model, opt = _run_port(spec, cfg, params, grads, start)
    got = _flat(port_yolo.params_to_jax(model))
    assert set(got) == set(ref)
    p0 = _flat(params)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    assert max(np.abs(ref[k] - p0[k]).max() for k in ref) > 1e-3
    assert opt.count == start + 5


def test_only_conv_weights_decay():
    """With zero gradients only the decay moves parameters: the conv
    weights shrink, conv biases and batch-norm scales and biases stay."""
    spec, params = _tiny_params()
    params = [{k: (np.full(np.shape(v), 0.5, np.float32)
                   if k in ("b", "bn_scale", "bn_bias") else v)
               for k, v in p.items()} for p in params]
    zeros = [[{k: np.zeros(np.shape(v), np.float32) for k, v in p.items()}
              for p in params]] * 5
    cfg = jax_train.YoloTrainConfig(lr=0.1, burn_in=0, steps=(100,),
                                    scales=(0.1,), decay=0.05)
    model, _ = _run_port(spec, cfg, params, zeros)
    ref = _flat(_run_optax(cfg, params, zeros))
    for k, v in _flat(port_yolo.params_to_jax(model)).items():
        p0 = _flat(params)[k]
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-7, err_msg=k)
        if k.endswith("/w"):
            assert np.abs(v).max() < np.abs(p0).max(), k
        else:
            np.testing.assert_array_equal(v, p0, err_msg=k)


def test_fast_forward_resumes_mid_curve():
    """After fast_forward(500) the first update applies lr(500) (past
    burn-in and past a step), as the JAX package's does, not lr(0) = 0."""
    spec, params = _tiny_params()
    cfg = jax_train.YoloTrainConfig(lr=1e-3, burn_in=100, steps=(200,),
                                    scales=(0.1,), decay=0.0)
    grads = _grad_lists(params, 2, 1)
    ref = _flat(_run_optax(cfg, params, grads, 500))
    model, opt = _run_port(spec, cfg, params, grads, 500)
    got = _flat(port_yolo.params_to_jax(model))
    p0, g = _flat(params), _flat(grads[0])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-9)
    k = "0/w"              # moved by lr(500) = 1e-4 times the gradient
    assert np.abs(p0[k] - got[k]).max() > 1e-6
    np.testing.assert_allclose(p0[k] - got[k], 1e-4 * g[k], rtol=0,
                               atol=1e-7)
    assert opt.count == 501


# ---------------------------------------------------------------------------
# Augmentation with JAX's draws
# ---------------------------------------------------------------------------

AUG_H, AUG_W, OUT_H, OUT_W, AUG_B = 48, 64, 32, 40, 8
AUG_CFG = dict(jitter=0.3, hue=0.1, saturation=1.5, exposure=1.5)


def jax_aug_draws(key, b, h, w, cfg):
    """The draws of the JAX `augment_detection_batch` for `key`, as it
    makes them: split(key, B); per sample (k1, k2) = split(k); the crop
    from split(k1, 5), the HSV from split(k2, 5)."""
    u = jax.random.uniform
    cols = {k: [] for k in port_train.DRAWS}
    for k in jax.random.split(key, b):
        k1, k2 = jax.random.split(k)
        c = jax.random.split(k1, 5)
        dw, dh = cfg.jitter * w, cfg.jitter * h
        for name, kk, lim in (("pleft", c[0], dw), ("pright", c[1], dw),
                              ("ptop", c[2], dh), ("pbot", c[3], dh)):
            cols[name].append(u(kk, minval=-lim, maxval=lim))
        cols["flip_u"].append(u(c[4]))
        s = jax.random.split(k2, 5)
        cols["dhue"].append(u(s[0], minval=-cfg.hue, maxval=cfg.hue))
        cols["sat_s"].append(u(s[1], minval=1.0, maxval=cfg.saturation))
        cols["sat_u"].append(u(s[2]))
        cols["exp_s"].append(u(s[3], minval=1.0, maxval=cfg.exposure))
        cols["exp_u"].append(u(s[4]))
    return {k: torch.from_numpy(np.array(jnp.stack(v)))
            for k, v in cols.items()}


@pytest.fixture(scope="module")
def aug_data():
    rng = np.random.default_rng(5)
    imgs = rng.random((AUG_B, AUG_H, AUG_W, 3)).astype(np.float32)
    imgs[1] = 0.5                      # grey: d == 0 in the HSV
    imgs[2, :, :, 0] = imgs[2, :, :, 1]        # ties mx == r == g
    truths = np.zeros((AUG_B, 4, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.3, 0.4, 0]
    truths[:, 1] = [0.05, 0.9, 0.08, 0.15, 0]    # near a corner: clipped
    truths[::2, 2] = [0.97, 0.03, 0.02, 0.02, 0]  # tiny, often cut away
    key = jax.random.PRNGKey(11)
    cfg = jax_train.YoloTrainConfig(**AUG_CFG)
    draws = jax_aug_draws(key, AUG_B, AUG_H, AUG_W, cfg)
    assert (draws["flip_u"] < 0.5).any() and (draws["flip_u"] >= 0.5).any()
    assert (draws["sat_u"] > 0.5).any() and (draws["sat_u"] <= 0.5).any()
    return types.SimpleNamespace(imgs=imgs, truths=truths, key=key, cfg=cfg,
                                 draws=draws)


def test_crop_jitter_matches_jax(aug_data):
    d = aug_data
    keys = jax.random.split(d.key, AUG_B)
    got_i, got_b = port_train.crop_jitter(
        torch.from_numpy(d.imgs), torch.from_numpy(d.truths),
        torch.from_numpy(d.truths[..., 0] != 0), d.draws, OUT_H, OUT_W)
    n_dropped = 0
    for i, k in enumerate(keys):
        k1, _ = jax.random.split(k)
        ref_i, ref_b = jax_train.crop_jitter(
            k1, jnp.asarray(d.imgs[i]), jnp.asarray(d.truths[i]),
            jnp.asarray(d.truths[i, :, 0] != 0), d.cfg.jitter, OUT_H, OUT_W)
        np.testing.assert_allclose(got_i[i].numpy(), np.asarray(ref_i),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(ref_b),
                                   rtol=0, atol=1e-6)
        n_dropped += int(((d.truths[i, :, 0] != 0)
                          & (np.asarray(ref_b)[:, 0] == 0)).sum())
    assert n_dropped > 0          # the validity test took boxes away


def test_distort_hsv_matches_jax(aug_data):
    d = aug_data
    keys = jax.random.split(d.key, AUG_B)
    got = port_train.distort_hsv(torch.from_numpy(d.imgs), d.draws)
    for i, k in enumerate(keys):
        _, k2 = jax.random.split(k)
        ref = jax_train.distort_hsv(k2, jnp.asarray(d.imgs[i]), d.cfg.hue,
                                    d.cfg.saturation, d.cfg.exposure)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-5)
    # the round trip alone, and the hue wrap flooring as jnp's %
    back = port_train._hsv_to_rgb(port_train._rgb_to_hsv(
        torch.from_numpy(d.imgs)))
    np.testing.assert_allclose(back.numpy(), d.imgs, atol=1e-5)
    h = torch.tensor([-0.25, -1e-3, 0.0, 0.999, 1.25])
    np.testing.assert_array_equal(torch.remainder(h, 1.0).numpy(),
                                  np.asarray(jnp.asarray(h.numpy()) % 1.0))


def test_augment_detection_batch_matches_jax(aug_data):
    """Per sample, against what the JAX `augment_detection_batch` maps over
    the batch (`crop_jitter` with k1, then `distort_hsv` with k2, for
    (k1, k2) = split(k)), and its boxes from the batched call.  Its
    batched images are not the bar: on the CPU the vmapped crop is up to
    6.9e-6 off JAX's own per-sample crop here (op by op; compiled, more),
    more than float32 rounding of these two-tap sums allows, and HSV
    carries that to 1.3e-5; the port is within 6e-8 of the per-sample
    crop."""
    d = aug_data
    _, ref_b = jax_train.augment_detection_batch(
        d.key, jnp.asarray(d.imgs), jnp.asarray(d.truths), d.cfg, OUT_H,
        OUT_W)
    got_i, got_b = port_train.augment_detection_batch(
        torch.from_numpy(d.imgs), torch.from_numpy(d.truths),
        port_train.YoloTrainConfig(**AUG_CFG), OUT_H, OUT_W,
        draws=d.draws)
    assert got_i.shape == (AUG_B, OUT_H, OUT_W, 3)
    for i, k in enumerate(jax.random.split(d.key, AUG_B)):
        k1, k2 = jax.random.split(k)
        img, _ = jax_train.crop_jitter(
            k1, jnp.asarray(d.imgs[i]), jnp.asarray(d.truths[i]),
            jnp.asarray(d.truths[i, :, 0] != 0), d.cfg.jitter, OUT_H, OUT_W)
        ref_i = jax_train.distort_hsv(k2, img, d.cfg.hue, d.cfg.saturation,
                                      d.cfg.exposure)
        np.testing.assert_allclose(got_i[i].numpy(), np.asarray(ref_i),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), rtol=0,
                               atol=1e-6)
    # the generator path: same shapes, in range, a different draw per seed
    g = torch.Generator().manual_seed(0)
    a, _ = port_train.augment_detection_batch(
        torch.from_numpy(d.imgs), torch.from_numpy(d.truths),
        port_train.YoloTrainConfig(**AUG_CFG), OUT_H, OUT_W, generator=g)
    assert a.shape == got_i.shape and 0 <= a.min() and a.max() <= 1
    assert not torch.equal(a, got_i)


# ---------------------------------------------------------------------------
# Train-mode batch norm and train steps
# ---------------------------------------------------------------------------

TINY_CFG = """
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,13,  16,30,  33,23
classes=1
num=3
ignore_thresh = .7
"""

# two heads, the coarse (large anchors) first as in YOLOv3's cfg: a
# shortcut, a route of one and of two layers, an upsample
TWO_HEAD_CFG = """
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 3,4,5
anchors = 6,8, 10,12, 14,10, 20,24, 30,20, 40,44
classes=2
num=6
ignore_thresh = .6
focal_loss=1

[route]
layers = -3

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers = -1, -7

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 0,1,2
anchors = 6,8, 10,12, 14,10, 20,24, 30,20, 40,44
classes=2
num=6
ignore_thresh = .7
"""


def test_train_mode_batch_norm_matches_jax():
    """One conv layer in train mode: darknet's normalization by the batch
    and its 0.99/0.01 roll with the biased variance, where
    `nn.BatchNorm2d` would roll 0.1 of the unbiased one."""
    rng = np.random.default_rng(3)
    spec = jax_yolo.build_spec(TINY_CFG)
    l = spec.layers[1]
    full = jax_yolo.init_params(jax.random.PRNGKey(2), spec)
    p = dict(full[1], bn_scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
             bn_bias=rng.normal(0, 0.5, 16).astype(np.float32),
             bn_mean=rng.normal(0, 0.5, 16).astype(np.float32),
             bn_var=rng.uniform(0.5, 2.0, 16).astype(np.float32))
    x = rng.normal(0.3, 1.0, (3, 8, 8, 8)).astype(np.float32)
    stats = {}
    y_j = jax_yolo._conv_layer(l, p, jnp.asarray(x), train=True,
                               bn_stats=stats, path=1)
    rolled = jax_yolo.apply_bn_updates([{}, p], stats)[1]
    model = port_yolo.params_from_jax(port_yolo.build_spec(TINY_CFG),
                                      [full[0], p, *full[2:]])
    layer = model.layers[1].train()
    y_p = layer(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(y_p.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(layer.bn.running_mean.numpy(),
                               np.asarray(rolled["bn_mean"]), atol=1e-6)
    np.testing.assert_allclose(layer.bn.running_var.numpy(),
                               np.asarray(rolled["bn_var"]), atol=1e-6)
    layer.eval()                       # eval mode is nn.BatchNorm2d's
    assert isinstance(layer.bn, torch.nn.BatchNorm2d)
    assert isinstance(layer.conv, torch.nn.Conv2d)


N_STEPS = 3


def _boxes(rng, b, t=4):
    tr = np.zeros((b, t, 5), np.float32)
    for i in range(b):
        for j in range(rng.integers(1, t)):
            w, h = rng.uniform(0.08, 0.6, 2)
            tr[i, j] = [rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), w, h,
                        rng.integers(0, 2)]
    return tr


@pytest.fixture(scope="module")
def two_head_steps():
    """The JAX package and the port from the same params through the same
    3 batches, float32: SGD with momentum and decay, burn-in over the
    steps.  The batch norms' scales are drawn from U(0.5, 1.5) and biases
    from N(0, 0.3), away from the init's 1 and 0, so that a swapped scale
    and bias would show."""
    spec_j = jax_yolo.build_spec(TWO_HEAD_CFG)
    rng = np.random.default_rng(0)
    params = []
    for p in jax_yolo.init_params(jax.random.PRNGKey(0), spec_j):
        if "bn_scale" in p:
            c = p["bn_scale"].shape
            p = dict(p, bn_scale=jnp.asarray(rng.uniform(0.5, 1.5, c),
                                             jnp.float32),
                     bn_bias=jnp.asarray(rng.normal(0, 0.3, c), jnp.float32))
        params.append(p)
    cfg = jax_train.YoloTrainConfig(lr=1e-3, burn_in=2, steps=(100,),
                                    scales=(0.1,), momentum=0.9, decay=5e-4)
    batches = [(rng.random((3, 64, 64, 3)).astype(np.float32),
                _boxes(rng, 3)) for _ in range(N_STEPS)]

    tx = jax_train.make_optimizer(cfg)
    step = jax_train.make_train_step(spec_j, tx, 64, 64, donate=False,
                                     matmul_precision="float32")
    p, st, jax_hist = params, tx.init(params), []
    for imgs, tr in batches:
        p, st, m = step(p, st, jnp.asarray(imgs), jnp.asarray(tr))
        jax_hist.append({k: float(v) for k, v in m.items()})

    spec = port_yolo.build_spec(TWO_HEAD_CFG)
    model = port_yolo.params_from_jax(spec, params)
    opt = port_train.make_optimizer(model, port_cfg(cfg))
    port_step = port_train.make_train_step(model, opt, 64, 64, "float32")
    port_hist = []
    for imgs, tr in batches:
        m = port_step(torch.from_numpy(imgs), torch.from_numpy(tr))
        port_hist.append({k: v.item() for k, v in m.items()})
    return types.SimpleNamespace(
        p0=_flat(params), pj=_flat(p), pp=_flat(port_yolo.params_to_jax(
            model)), jax_hist=jax_hist, port_hist=port_hist)


def test_two_head_train_steps_match_jax(two_head_steps):
    for mj, mp in zip(two_head_steps.jax_hist, two_head_steps.port_hist):
        assert set(mj) == set(mp)
        np.testing.assert_allclose(mp["loss"], mj["loss"], rtol=1e-4)
        for k in mj:
            if k.endswith(("count", "avg_iou")):
                np.testing.assert_allclose(mp[k], mj[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
    assert two_head_steps.jax_hist[0]["head0/count"] > 0
    assert two_head_steps.jax_hist[0]["head1/count"] > 0


def test_two_head_params_after_steps_match_jax(two_head_steps):
    p0, pj, pp = two_head_steps.p0, two_head_steps.pj, two_head_steps.pp
    assert set(pp) == set(pj)
    train = [k for k in pj if not k.endswith(("bn_mean", "bn_var"))]
    biggest = max(np.abs(pj[k] - p0[k]).max() for k in train)
    assert biggest > 1e-3
    worst = max(np.abs(pp[k] - pj[k]).max() for k in train)
    assert worst <= 1e-3 * biggest, (worst, biggest)
    stats = [k for k in pj if k not in train]
    assert max(np.abs(pj[k] - p0[k]).max() for k in stats) > 1e-3
    for k in stats:
        np.testing.assert_allclose(pp[k], pj[k], rtol=0,
                                   atol=1e-5 * np.abs(pj[k]).max(), err_msg=k)


def test_overfit_regresses_planted_boxes():
    """The port alone: the JAX package's TestConvergence (six scenes, one
    bright square each) at fewer steps; the assigned anchor regresses its
    box onto the square."""
    spec = port_yolo.build_spec(TINY_CFG)
    model = port_yolo.Darknet(spec, 64, torch.Generator().manual_seed(0))
    cfg = port_train.YoloTrainConfig(lr=4e-3, burn_in=0, steps=(10 ** 6,),
                                     scales=(0.1,))
    opt = port_train.make_optimizer(model, cfg)
    step = port_train.make_train_step(model, opt, 64, 64, "float32")
    rng = np.random.default_rng(0)
    imgs = np.zeros((6, 64, 64, 3), np.float32)
    truths = np.zeros((6, 10, 5), np.float32)
    for i in range(6):
        img = rng.integers(0, 60, (64, 64, 3)).astype(np.float32)
        x, y = 16 + 4 * i % 20, 20 + 3 * i % 18
        img[y:y + 20, x:x + 20] = 220
        imgs[i] = img / 255.0
        truths[i, 0] = [(x + 10) / 64, (y + 10) / 64, 20 / 64, 20 / 64, 0]
    imgs_t, truths_t = torch.from_numpy(imgs), torch.from_numpy(truths)
    losses = []
    for _ in range(150):
        m = step(imgs_t, truths_t)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]
    assert m["head0/avg_iou"].item() > 0.7, m["head0/avg_iou"].item()


# ---------------------------------------------------------------------------
# The selftest's YOLO loop, step by step (ROADMAP Queue 3 item 4)
# ---------------------------------------------------------------------------

SELFTEST_STEPS, SELFTEST_B, SELFTEST_RESO = 20, 4, 64


def _jax_draws_batched(key, b, h, w, cfg):
    """`jax_aug_draws`, vmapped over the batch's per-sample keys."""
    dw, dh = cfg.jitter * w, cfg.jitter * h

    def one(k):
        u = jax.random.uniform
        k1, k2 = jax.random.split(k)
        c = jax.random.split(k1, 5)
        s = jax.random.split(k2, 5)
        return {"pleft": u(c[0], minval=-dw, maxval=dw),
                "pright": u(c[1], minval=-dw, maxval=dw),
                "ptop": u(c[2], minval=-dh, maxval=dh),
                "pbot": u(c[3], minval=-dh, maxval=dh), "flip_u": u(c[4]),
                "dhue": u(s[0], minval=-cfg.hue, maxval=cfg.hue),
                "sat_s": u(s[1], minval=1.0, maxval=cfg.saturation),
                "sat_u": u(s[2]),
                "exp_s": u(s[3], minval=1.0, maxval=cfg.exposure),
                "exp_u": u(s[4])}

    out = jax.jit(jax.vmap(one))(jax.random.split(key, b))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def selftest_yolo_steps():
    """The fast selftest's YOLO loop (`tools/selftest.run_selftest` stage
    3a: its 5-conv cfg, its rendered scenes and box truths, its batch
    indices from the seeded host rng, its per-iteration key splits) for
    20 steps at reso 64, float32, in both packages from the JAX init.  The
    port replays the JAX package's draws in its own batched augmentation;
    the JAX side augments per sample.  The recipe's rate, momentum
    and decay, without its 200-step burn-in: inside the burn-in the rate
    is lr * (it / 200)^4, under 1e-7 for these steps, and the updates
    would be too small to compare."""
    from betapose_tpu.tools import selftest as jax_st
    from betapose_tpu_torch.tools import selftest as port_st
    rng = np.random.default_rng(0)
    model3d = jax_st.CubeModel()
    frames, truths = [], []
    for _ in range(8):
        frame, _, bb = jax_st.make_scene(rng, model3d, (0.55, 0.8))
        frames.append(frame)
        t = np.zeros((4, 5), np.float32)
        t[0] = [(bb[0] + bb[2]) / 2 / 640, (bb[1] + bb[3]) / 2 / 480,
                (bb[2] - bb[0]) / 640, (bb[3] - bb[1]) / 480, 0]
        truths.append(t)
    frames, truths = np.stack(frames), np.stack(truths)
    assert jax_st.YOLO_CFG == port_st.YOLO_CFG
    spec_j = jax_yolo.build_spec(jax_st.YOLO_CFG.format(reso=SELFTEST_RESO))
    params = jax_yolo.init_params(jax.random.PRNGKey(0), spec_j)
    cfg = jax_train.YoloTrainConfig(lr=1e-3, burn_in=0, steps=(10 ** 6,),
                                    scales=(0.1,), decay=5e-4)
    tx = jax_train.make_optimizer(cfg)
    jstep = jax_train.make_train_step(spec_j, tx, SELFTEST_RESO,
                                      SELFTEST_RESO, donate=False,
                                      matmul_precision="float32")
    spec = port_yolo.build_spec(port_st.YOLO_CFG.format(reso=SELFTEST_RESO))
    model = port_yolo.params_from_jax(spec, params, SELFTEST_RESO)
    pstep = port_train.make_train_step(
        model, port_train.make_optimizer(model, port_cfg(cfg)),
        SELFTEST_RESO, SELFTEST_RESO, "float32")
    p, st, key = params, tx.init(params), jax.random.PRNGKey(3)
    hist = []
    for _ in range(SELFTEST_STEPS):
        sel = rng.integers(0, len(frames), SELFTEST_B)
        key, k1 = jax.random.split(key)
        # what the JAX `augment_detection_batch` maps over the batch, per
        # sample (its vmapped crop is 1e-5-3.5e-5 off this at 480x640 ->
        # 64x64, and a float32 training run amplifies any such noise)
        x = jnp.asarray(frames[sel]).astype(jnp.float32) / 255.0
        imgs, tr = [], []
        for i, k in enumerate(jax.random.split(k1, SELFTEST_B)):
            ka, kb = jax.random.split(k)
            t_i = jnp.asarray(truths[sel][i])
            img, box = jax_train.crop_jitter(
                ka, x[i], t_i, t_i[:, 0] != 0, cfg.jitter, SELFTEST_RESO,
                SELFTEST_RESO)
            imgs.append(jax_train.distort_hsv(kb, img, cfg.hue,
                                              cfg.saturation, cfg.exposure))
            tr.append(box)
        p, st, mj = jstep(p, st, jnp.stack(imgs), jnp.stack(tr))
        pimgs, ptr = port_train.augment_detection_batch(
            torch.from_numpy(frames[sel]).float() / 255.0,
            torch.from_numpy(truths[sel]), port_cfg(cfg), SELFTEST_RESO,
            SELFTEST_RESO, draws=_jax_draws_batched(
                k1, SELFTEST_B, 480, 640, cfg))
        mp = pstep(pimgs, ptr)
        # copies: params_to_jax's arrays share the CPU tensors' memory
        hist.append((_flat(p), {k: v.copy() for k, v in _flat(
            port_yolo.params_to_jax(model)).items()},
                     {k: float(v) for k, v in mj.items()},
                     {k: v.item() for k, v in mp.items()}))
    return _flat(params), hist


def test_selftest_yolo_steps_match_jax(selftest_yolo_steps):
    """After every one of the 20 steps: the trained parameters within
    1e-4 of the largest update so far, the batch-norm statistics within
    1e-4 of their largest, the loss within 2e-5 relative and avg_iou
    within 2e-5 (float32 on both sides; measured: 3.5e-6, 6.6e-6, 4.1e-6
    and 4.3e-6).  Training one package on the other's batched crop instead
    (1e-5-3.5e-5 apart) moves them 2e-2 apart in 20 steps: any draw,
    rounding or init difference grows the same way."""
    p0, hist = selftest_yolo_steps
    for it, (pj, pp, mj, mp) in enumerate(hist):
        train = [k for k in pj if not k.endswith(("bn_mean", "bn_var"))]
        biggest = max(np.abs(pj[k] - p0[k]).max() for k in train)
        worst = max(np.abs(pp[k] - pj[k]).max() for k in train)
        assert worst <= 1e-4 * biggest, (it, worst, biggest)
        for k in set(pj) - set(train):
            np.testing.assert_allclose(pp[k], pj[k], rtol=0,
                                       atol=1e-4 * np.abs(pj[k]).max(),
                                       err_msg=f"step {it} {k}")
        np.testing.assert_allclose(mp["loss"], mj["loss"], rtol=2e-5,
                                   err_msg=f"step {it}")
        np.testing.assert_allclose(mp["head0/avg_iou"], mj["head0/avg_iou"],
                                   rtol=0, atol=2e-5, err_msg=f"step {it}")
    assert hist[-1][2]["head0/count"] > 0
    assert max(np.abs(hist[-1][0][k] - p0[k]).max() for k in p0) > 1e-3


def test_draw_random_has_jax_distributions():
    """The port's own draws (`draw_random` from a torch.Generator) against
    the JAX package's per-sample keys: 4096 draws per field from each, a
    two-sample Kolmogorov-Smirnov test per field at p > 1e-3.  With the
    step held to JAX's on the same draws (above), this holds each
    package's training from its own draws to the same distribution."""
    from scipy.stats import ks_2samp
    n = 4096
    cfg = jax_train.YoloTrainConfig()
    ref = _jax_draws_batched(jax.random.PRNGKey(7), n, 480, 640, cfg)
    got = port_train.draw_random(n, 480, 640, port_cfg(cfg),
                                 torch.Generator().manual_seed(7))
    assert set(got) == set(ref) == set(port_train.DRAWS)
    for k in port_train.DRAWS:
        g, r = got[k].numpy(), ref[k].numpy()
        assert g.min() >= r.min() - 0.02 * np.ptp(r)
        assert g.max() <= r.max() + 0.02 * np.ptp(r)
        assert ks_2samp(g, r).pvalue > 1e-3, k
