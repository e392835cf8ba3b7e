"""The PyTorch port's KPD training (`betapose_tpu_torch/train/kpd_train.py`)
against the JAX package's (`betapose_tpu/train/kpd_train.py`) on the CPU,
float32 on both sides (XLA's CPU ignores the bf16 precision setting):

- `masked_mse_loss`, `pck_accuracy` and the symmetry-aware loss (min over
  modes, accuracy against the chosen mode) within 1e-6;
- three FastPose (resnet50, 4 keypoints, 64x32 crops, batch 4) train
  steps with rmsprop, momentum 0.9 and weight decay 1e-4: loss and acc
  within 1e-4 relative, parameters within 1e-3 of the largest parameter
  update, batch-norm running statistics within 1e-5 of each one's
  largest.  The batch norms' scales are drawn from U(0.1, 0.3) and their
  biases from U(0.5, 1.5), so that few ReLU inputs sit near zero: with
  the init's unit scales and zero biases, float32 rounding alone (either
  package against float64) moves this forward by ~1e-4 relative, which
  flips the ReLUs whose input is that close to zero and moves the
  gradients by ~3%; rmsprop's first step is nearly sign(g) * 10 lr, so no
  two float32 implementations then agree to 1e-3 of the update (measured:
  2.0x the update at the init, 1.1e-5 of it here);
- the optimizers against optax over 5 steps within 1e-7, and
  `torch.optim.RMSprop` outside that bar (eps outside the root);
- the straight-through bf16 rounding of the convs keeps float32
  gradients, where `.bfloat16().float()` rounds them;
- one hgPRM (nFeats 16, nStack 2) train step: the loss of JAX's
  `forward(train=True, all_heads=True)`, running statistics unchanged;
- `flip_tta_step` and the eval step.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from betapose_tpu.models import hgprm as jax_hg  # noqa: E402
from betapose_tpu.models import kpd as jax_kpd  # noqa: E402
from betapose_tpu.ops import heatmap as jax_hm  # noqa: E402
from betapose_tpu.train import kpd_train as jax_train  # noqa: E402
from betapose_tpu_torch.models import hgprm as port_hg  # noqa: E402
from betapose_tpu_torch.models import kpd as port_kpd  # noqa: E402
from betapose_tpu_torch.models import precision  # noqa: E402
from betapose_tpu_torch.train import kpd_train as port_train  # noqa: E402

B, K, IH, IW, OH, OW = 4, 4, 64, 32, 16, 8


def make_batch(seed, b=B, ih=IH, iw=IW, oh=OH, ow=OW, k=K):
    """NHWC inputs, gaussian labels at random points (one map left empty:
    an invisible keypoint), a set_mask of ones; returns the port's batch
    ([B,K,H,W] maps) and the JAX one (NHWC maps)."""
    rng = np.random.default_rng(seed)
    inps = rng.normal(0, 0.5, (b, ih, iw, 3)).astype(np.float32)
    pts = rng.uniform(1, [ow - 1, oh - 1], (b, k, 2)).astype(np.float32)
    labels = np.array(jax_hm.draw_gaussian_batch(jnp.asarray(pts), oh, ow))
    labels[0, -1] = 0
    mask = np.ones_like(labels)
    port = {"inps": torch.from_numpy(inps), "labels": torch.from_numpy(labels),
            "set_mask": torch.from_numpy(mask)}
    nhwc = {"inps": jnp.asarray(inps),
            "labels": jnp.asarray(labels.transpose(0, 2, 3, 1)),
            "set_mask": jnp.asarray(mask.transpose(0, 2, 3, 1))}
    return port, nhwc


def leaves(tree):
    """{keystr: array} of a param tree."""
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(0)
    port, nhwc = make_batch(0)
    out = rng.normal(0, 0.3, (B, K, OH, OW)).astype(np.float32)
    out[1] = port["labels"][1].numpy() * 0.9       # a sample mostly right
    out_j = jnp.asarray(out.transpose(0, 2, 3, 1))
    t_out = torch.from_numpy(out)
    got = port_train.masked_mse_loss(t_out, port["labels"], port["set_mask"])
    ref = jax_train.masked_mse_loss(out_j, nhwc["labels"], nhwc["set_mask"])
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    acc, n = port_train.pck_accuracy(t_out, port["labels"], OH)
    acc_j, n_j = jax_train.pck_accuracy(out_j, nhwc["labels"], OH)
    assert int(n) == int(n_j) == B * K - 1
    np.testing.assert_allclose(acc.item(), float(acc_j), rtol=1e-6)
    assert 0 < acc.item() < 1

    # the symmetry-aware loss through each package's loss function: the
    # "network" returns its params (the heatmaps, or two heads of them)
    perms = [np.asarray([1, 0, 3, 2]), np.asarray([2, 3, 0, 1])]
    for heads in (1, 2):
        outs = [out_j * (1.0 + 0.1 * h) for h in range(heads)]
        fwd = (lambda p, x, train=False, bn_stats=None:
               p if heads > 1 else p[0])
        loss_j, (acc_j, _) = jax_train.make_loss_fn(
            OH, fwd, "float32", sym_perms=perms)(outs, nhwc)
        t_outs = [torch.from_numpy(np.array(o).transpose(0, 3, 1, 2))
                  for o in outs]
        loss, acc, _ = port_train.make_loss_fn(OH, perms)(
            t_outs if heads > 1 else t_outs[0], port["labels"],
            port["set_mask"])
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
        np.testing.assert_allclose(acc.item(), float(acc_j), rtol=1e-6)


N_STEPS = 3


@pytest.fixture(scope="module")
def fastpose_steps():
    """JAX and the port from the same weights through the same 3 batches:
    rmsprop, momentum 0.9, weight decay 1e-4, float32."""
    rng = np.random.default_rng(0)
    draw = {"scale": lambda s: rng.uniform(0.1, 0.3, s),
            "bias": lambda s: rng.uniform(0.5, 1.5, s),
            "mean": lambda s: rng.normal(0.0, 0.1, s),
            "var": lambda s: rng.uniform(0.5, 2.0, s)}

    def fill(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in draw and "fc1" not in keys and "fc2" not in keys \
                and "conv_out" not in keys:
            return jnp.asarray(draw[keys[-1]](leaf.shape), jnp.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(
        fill, jax_kpd.init_params(jax.random.PRNGKey(0), K, "resnet50"))
    batches = [make_batch(s) for s in range(N_STEPS)]
    tx = jax_train.make_optimizer("rmsprop", 2.5e-4, 0.9, 1e-4,
                                  params_example=params)
    step = jax_train.make_train_step(tx, out_res_h=OH, donate=False,
                                     matmul_precision="float32")
    p, st, jax_hist = params, tx.init(params), []
    for _, nhwc in batches:
        p, st, m = step(p, st, nhwc)
        jax_hist.append((float(m["loss"]), float(m["acc"])))

    model = port_kpd.FastPose(K, "resnet50")
    model.load_state_dict(port_kpd.state_dict_from_jax(params))
    opt = port_train.make_optimizer(model.parameters(), "rmsprop", 2.5e-4,
                                    0.9, 1e-4)
    port_step = port_train.make_train_step(model, opt, OH, "float32")
    port_hist = []
    for port, _ in batches:
        m = port_step(port)
        port_hist.append((m["loss"].item(), m["acc"].item()))
    return types.SimpleNamespace(
        p0=leaves(params), pj=leaves(p), jax_params=p,
        pp=leaves(port_kpd.params_from_state_dict(model.state_dict())),
        jax_hist=jax_hist, port_hist=port_hist, model=model)


def test_fastpose_train_steps_match_jax(fastpose_steps):
    jax_hist, port_hist = fastpose_steps.jax_hist, fastpose_steps.port_hist
    for (lj, aj), (lp, ap) in zip(jax_hist, port_hist):
        np.testing.assert_allclose(lp, lj, rtol=1e-4)
        np.testing.assert_allclose(ap, aj, rtol=1e-4)
    assert np.isfinite(port_hist).all()


def test_fastpose_params_after_steps_match_jax(fastpose_steps):
    p0, pj, pp = fastpose_steps.p0, fastpose_steps.pj, fastpose_steps.pp
    assert set(pp) == set(pj)
    train = [k for k in pj if not k.endswith(("['mean']", "['var']"))]
    biggest = max(np.abs(pj[k] - p0[k]).max() for k in train)
    assert biggest > 1e-3
    worst = max(np.abs(pp[k] - pj[k]).max() for k in train)
    assert worst <= 1e-3 * biggest, (worst, biggest)
    stats = [k for k in pj if k not in train]
    assert max(np.abs(pj[k] - p0[k]).max() for k in stats) > 1e-3
    for k in stats:                                  # BN running stats
        np.testing.assert_allclose(pp[k], pj[k], rtol=0,
                                   atol=1e-5 * np.abs(pj[k]).max(), err_msg=k)


def test_eval_and_flip_tta_match_jax(fastpose_steps):
    tree, model = fastpose_steps.jax_params, fastpose_steps.model
    port, nhwc = make_batch(9)
    ref = jax.jit(jax_train.flip_tta_step)(tree, nhwc["inps"])
    model.eval()
    got = port_train.flip_tta_step(model, port["inps"])
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    m_j = jax_train.make_eval_step(OH)(tree, nhwc)
    m_p = port_train.make_eval_step(OH)(model, port)
    np.testing.assert_allclose(m_p["loss"].item(), float(m_j["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(m_p["acc"].item(), float(m_j["acc"]),
                               rtol=1e-4)
    assert int(m_p["n"]) == int(m_j["n"])


OPTIMIZERS = [("rmsprop", 0.0, 0.0), ("rmsprop", 0.9, 1e-4),
              ("adam", 0.0, 0.0), ("adam", 0.0, 1e-4),
              ("sgd", 0.0, 0.0), ("sgd", 0.9, 1e-4)]


def grads_and_param(seed=0):
    """A parameter and 5 gradients spanning 1e-6..1 in magnitude, where
    eps inside or outside the root matters."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 0.1, (64,)).astype(np.float32)
    scale = 10.0 ** rng.uniform(-6, 0, (5, 64))
    gs = (rng.normal(0, 1, (5, 64)) * scale).astype(np.float32)
    return p, gs


def run_port(opt_cls_or_fn, p, gs):
    t = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = opt_cls_or_fn([t])
    for g in gs:
        t.grad = torch.from_numpy(g.copy())
        opt.step()
    return t.detach().numpy()


@pytest.mark.parametrize("method,momentum,wd", OPTIMIZERS)
def test_optimizer_matches_optax(method, momentum, wd):
    p, gs = grads_and_param()
    tx = jax_train.make_optimizer(method, 2.5e-4, momentum, wd)
    pj, st = jnp.asarray(p), tx.init(jnp.asarray(p))
    for g in gs:
        u, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, u)
    got = run_port(lambda ps: port_train.make_optimizer(
        ps, method, 2.5e-4, momentum, wd), p, gs)
    np.testing.assert_allclose(got, np.asarray(pj), rtol=0, atol=1e-7)
    assert np.abs(got - p).max() > 1e-4                # it moved


def test_torch_rmsprop_is_not_optax():
    """torch divides by sqrt(nu) + eps: at a gradient of 1e-4 its first
    step is ~10 lr, optax's ~1 lr."""
    p, gs = grads_and_param()
    tx = jax_train.make_optimizer("rmsprop", 2.5e-4, 0.0, 0.0)
    pj, st = jnp.asarray(p), tx.init(jnp.asarray(p))
    for g in gs:
        u, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, u)
    got = run_port(lambda ps: torch.optim.RMSprop(
        ps, lr=2.5e-4, alpha=0.99, eps=1e-8), p, gs)
    assert np.abs(got - np.asarray(pj)).max() > 1e-5


def test_straight_through_rounding_keeps_f32_gradients():
    rng = np.random.default_rng(2)
    conv = precision.Conv2d(8, 16, 3, padding=1, bias=False)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 6, 5)).astype(np.float32))
    g_out = torch.from_numpy(rng.normal(0, 1, (2, 16, 6, 5))
                             .astype(np.float32))

    def grads(fn):
        xl = x.clone().requires_grad_()
        conv.weight.grad = None
        y = fn(xl)
        y.backward(g_out)
        return y.detach(), xl.grad, conv.weight.grad.clone()

    with precision.conv_precision(conv, "bfloat16"):
        y_st, gx_st, gw_st = grads(conv)
    assert conv.precision == "float32"                # restored
    x_r = x.bfloat16().float()
    w_r = conv.weight.detach().bfloat16().float()
    # forward: the float32 conv of the bf16-rounded operands, exactly
    ref = torch.nn.functional.conv2d(x_r, w_r, padding=1)
    assert torch.equal(y_st, ref)
    # backward: float32 gradients (the conv's own, at the rounded
    # operands), not rounded to bf16
    xl = x_r.clone().requires_grad_()
    wl = w_r.clone().requires_grad_()
    torch.nn.functional.conv2d(xl, wl, padding=1).backward(g_out)
    assert torch.equal(gx_st, xl.grad) and torch.equal(gw_st, wl.grad)
    assert not torch.equal(gx_st, gx_st.bfloat16().float())
    # the cast form rounds the gradients to bf16 in its backward
    _, gx_c, gw_c = grads(lambda xl: torch.nn.functional.conv2d(
        xl.bfloat16().float(), conv.weight.bfloat16().float(), padding=1))
    assert not torch.equal(gx_c, gx_st) and not torch.equal(gw_c, gw_st)
    assert torch.equal(gx_c, gx_c.bfloat16().float())


def test_hgprm_train_step_matches_jax_loss():
    params = jax_hg.init_params(jax.random.PRNGKey(1), K, n_feats=16,
                                n_stack=2)
    port, nhwc = make_batch(4, b=2, ih=64, iw=64, oh=16, ow=16)
    outs = jax.jit(lambda p, x: jax_hg.forward(
        p, x, all_heads=True, train=True))(params, nhwc["inps"])
    ref = sum(float(jax_train.masked_mse_loss(o, nhwc["labels"],
                                              nhwc["set_mask"]))
              for o in outs)
    model = port_hg.PyraNet(K, n_feats=16, n_stack=2)
    model.load_state_dict(port_hg.state_dict_from_jax(params))
    buffers = {k: v.clone() for k, v in model.state_dict().items()
               if "running" in k}
    before = [p.detach().clone() for p in model.parameters()]
    opt = port_train.make_optimizer(model.parameters(), "rmsprop")
    m = port_train.make_train_step(model, opt, 16, "float32")(port)
    np.testing.assert_allclose(m["loss"].item(), ref, rtol=1e-4)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, buffers[k]), k
    assert any(not torch.equal(a, b) for a, b in
               zip(before, model.parameters()))
