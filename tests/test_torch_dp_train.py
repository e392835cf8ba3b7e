"""Data-parallel training in the port (`train/kpd_train.make_train_step`
and `train/yolo_train.make_train_step` with a `data` group, the batch
norms synchronized over it) on four gloo CPU ranks, global batch 8,
against the port's single process and the JAX package's DP step over a
4-device mesh, float32, at the bars of tests/test_train.py (loss within
1e-5 relative at step 1 and 1e-3 at step 2, parameters within 1e-3):

- FastPose (resnet50, 4 keypoints, 64x32, sgd) and tiny-cfg YOLO two
  steps; hgPRM (nFeats 16, nStack 2, sgd) two steps against the single
  process, its first loss against JAX's forward on the global batch;
- parameters and batch-norm buffers bitwise equal across the ranks after
  the two steps;
- YOLO's gradients are summed: averaging them instead (1/4 of the JAX
  update) fails the parameter bar;
- `train_kpd_main --n_devices 2 --device cpu` gives what one device
  gives (the `detector train -gpus 0,1` counterpart is in
  tests/test_torch_yolo_train_cli.py);
- the four ranks of `entry.dryrun_multichip(4)` (its rank body, run in
  the same spawn as the train steps) give the JAX dryrun's line, and its
  DP and DP x TP KPD losses are the single-process loss on the same
  batch.

Each group of rank work runs in one spawn (`parallel/launch.run_ranks`);
the rank bodies import no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

K = 4
YOLO_CFG = """
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
HG = dict(n_feats=16, n_stack=2)


def yolo_inputs(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.random((8, 64, 64, 3)).astype(np.float32)
    truths = np.zeros((8, 4, 5), np.float32)
    truths[:, :2, :2] = rng.uniform(0.2, 0.8, (8, 2, 2))
    truths[:, :2, 2:4] = rng.uniform(0.1, 0.4, (8, 2, 2))
    return imgs, truths


def yolo_cfg():
    from betapose_tpu_torch.train import yolo_train
    return yolo_train.YoloTrainConfig(lr=1e-3, burn_in=0, steps=(10 ** 6,),
                                      scales=(0.1,))


def away_from_zero(sd, seed):
    """The batch norms' scales from U(0.1, 0.3) and biases from U(0.5,
    1.5), as tests/test_torch_kpd_train.py draws them: with ReLU inputs
    near zero, float32 rounding (a batch of 2 against one of 8) flips
    ReLUs and moves the gradients by percents."""
    rng = np.random.default_rng(seed)
    for k in [k[:-len(".running_mean")] for k in sd
              if k.endswith(".running_mean")]:
        sd[k + ".weight"] = rng.uniform(0.1, 0.3, sd[k + ".weight"].shape
                                        ).astype(np.float32)
        sd[k + ".bias"] = rng.uniform(0.5, 1.5, sd[k + ".bias"].shape
                                      ).astype(np.float32)
    return sd


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def train_models(group, kpd_sd, kpd_batches, hg_sd, hg_batches, yolo_sd,
                 yolo_batches, mesh=None):
    """Two steps of each network, on this rank's rows when `mesh` is
    given; {"kpd"|"hg"|"yolo": (losses, accs or metrics, state)}."""
    from betapose_tpu_torch.models import hgprm, kpd as kpd_mod
    from betapose_tpu_torch.models import yolov3 as yolo_mod
    from betapose_tpu_torch.parallel import mesh as mesh_mod
    from betapose_tpu_torch.parallel.layers import set_batch_norm_group
    from betapose_tpu_torch.train import kpd_train, yolo_train

    def rows(tree):
        tree = {k: torch.from_numpy(v) for k, v in tree.items()}
        return mesh_mod.shard_batch(mesh, tree) if mesh else tree

    out = {}
    for name, model, batches in (
            ("kpd", kpd_mod.FastPose(K, "resnet50"), kpd_batches),
            ("hg", hgprm.PyraNet(K, **HG), hg_batches)):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               (kpd_sd if name == "kpd" else hg_sd).items()})
        set_batch_norm_group(model, group)
        opt = kpd_train.make_optimizer(model.parameters(), "sgd", 1e-2)
        step = kpd_train.make_train_step(model, opt, 16, "float32",
                                         group=group)
        ms = [step(rows(b)) for b in batches]
        out[name] = ([float(m["loss"]) for m in ms],
                     [float(m["acc"]) for m in ms], _state(model))
    spec = yolo_mod.build_spec(YOLO_CFG)
    model = yolo_mod.Darknet(spec, 64)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in yolo_sd.items()})
    set_batch_norm_group(model, group)
    step = yolo_train.make_train_step(
        model, yolo_train.make_optimizer(model, yolo_cfg()), 64, 64,
        "float32", group)
    ms = [step(**rows(b)) for b in yolo_batches]
    out["yolo"] = ([float(m["loss"]) for m in ms],
                   [{k: float(v) for k, v in m.items()} for m in ms],
                   _state(model))
    return out


def _rank(*inputs):
    import torch.distributed as dist
    from betapose_tpu_torch import entry
    from betapose_tpu_torch.parallel import collectives as coll
    from betapose_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(4)
    group = mesh_mod.axis_group(mesh, "data")
    out = train_models(group, *inputs, mesh=mesh)
    # every rank holds the same parameters and buffers, bit for bit
    mine = {n: out[n][2] for n in out}
    every = [None] * 4
    dist.all_gather_object(every, mine)
    same = all(np.array_equal(every[r][n][k], mine[n][k])
               for r in range(4) for n in mine for k in mine[n])
    # YOLO with its gradients averaged instead of summed
    real = coll.all_reduce_grads
    coll.all_reduce_grads = lambda params, grp, op: real(params, grp,
                                                         "mean")
    try:
        mean = train_models(group, inputs[0], [], inputs[2], [],
                            inputs[4], inputs[5][:1], mesh=mesh)["yolo"]
    finally:
        coll.all_reduce_grads = real
    return out, same, mean, entry._dryrun_rank(4)


@pytest.fixture(scope="module")
def runs():
    from betapose_tpu_torch.models import hgprm, kpd as kpd_mod
    from betapose_tpu_torch.models import yolov3 as yolo_mod
    from betapose_tpu_torch.parallel import launch
    from tests.test_torch_kpd import random_kpd_params
    from tests.test_torch_kpd_train import make_batch

    kpd_sd = away_from_zero({k: v.numpy() for k, v in
                             kpd_mod.state_dict_from_jax(random_kpd_params(
                                 K, "resnet50", 3)).items()}, 0)
    kpd_params = kpd_mod.params_from_state_dict(kpd_sd)
    kb = [make_batch(s, b=8) for s in (0, 1)]
    hb = [make_batch(s, b=8, ih=64, iw=64, oh=16, ow=16) for s in (2, 3)]
    hg_sd = away_from_zero(_state(hgprm.PyraNet(
        K, generator=torch.Generator().manual_seed(1), **HG)), 1)
    yolo_sd = _state(yolo_mod.Darknet(yolo_mod.build_spec(YOLO_CFG), 64,
                                      torch.Generator().manual_seed(1)))
    yb = [dict(zip(("images", "truths"), yolo_inputs(s))) for s in (4, 5)]

    def port(batches):
        return [{k: v.numpy() for k, v in p.items()} for p, _ in batches]

    inputs = (kpd_sd, port(kb), hg_sd, port(hb), yolo_sd, yb)
    dp, same, mean, dryrun = launch.run_ranks(_rank, 4, "cpu", *inputs)
    single = train_models(None, *inputs)
    single1 = train_models(None, kpd_sd, [], hg_sd, [], yolo_sd,
                           yb[:1])["yolo"]
    return dict(dp=dp, same=same, mean=mean, dryrun=dryrun, single=single,
                single1=single1,
                kpd_params=kpd_params, kb=kb, hb=hb, yb=yb, hg_sd=hg_sd,
                yolo_sd=yolo_sd)


def assert_bars(losses, ref_losses, state, ref_state):
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses[1], ref_losses[1], rtol=1e-3)
    assert set(state) == set(ref_state)
    for k in state:
        np.testing.assert_allclose(state[k], ref_state[k], rtol=0,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("net", ["kpd", "hg", "yolo"])
def test_dp_step_matches_the_single_process_step(runs, net):
    dp, single = runs["dp"][net], runs["single"][net]
    assert_bars(dp[0], single[0], dp[2], single[2])
    if net == "yolo":    # the head metrics are the global batch's
        for k, v in single[1][0].items():
            np.testing.assert_allclose(dp[1][0][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    else:
        np.testing.assert_allclose(dp[1], single[1], rtol=1e-5)


def test_ranks_hold_the_same_bits(runs):
    assert runs["same"]


def test_fastpose_dp_step_matches_the_jax_dp_step(runs):
    import jax
    from betapose_tpu.models import kpd as jax_kpd
    from betapose_tpu.parallel import mesh as jmesh
    from betapose_tpu.train import kpd_train as jax_train
    params = runs["kpd_params"]
    tx = jax_train.make_optimizer("sgd", 1e-2, params_example=params)
    step = jax_train.make_train_step(tx, out_res_h=16, donate=False,
                                     matmul_precision="float32")
    mesh = jmesh.make_mesh(4)
    p, st = jmesh.replicate(mesh, params), jmesh.replicate(mesh,
                                                          tx.init(params))
    losses = []
    for _, nhwc in runs["kb"]:
        p, st, m = step(p, st, jmesh.shard_batch(mesh, nhwc))
        losses.append(float(m["loss"]))
    dp = runs["dp"]["kpd"]
    got = jax_kpd.torch_state_dict_to_params(
        {k: torch.from_numpy(v) for k, v in dp[2].items()}, K, "resnet50")
    np.testing.assert_allclose(dp[0][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(dp[0][1], losses[1], rtol=1e-3)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(p)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))


def test_yolo_dp_step_matches_the_jax_dp_step(runs):
    import jax.numpy as jnp
    from betapose_tpu.models import yolov3 as jax_yolo
    from betapose_tpu.parallel import mesh as jmesh
    from betapose_tpu.train import yolo_train as jax_train
    from betapose_tpu_torch.models import yolov3 as port_yolo
    spec = jax_yolo.build_spec(YOLO_CFG)
    model = port_yolo.Darknet(port_yolo.build_spec(YOLO_CFG), 64)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in runs["yolo_sd"].items()})
    params = [{k: jnp.asarray(v) for k, v in layer.items()}
              for layer in port_yolo.params_to_jax(model)]
    c = yolo_cfg()
    tx = jax_train.make_optimizer(jax_train.YoloTrainConfig(
        lr=c.lr, burn_in=c.burn_in, steps=c.steps, scales=c.scales))
    step = jax_train.make_train_step(spec, tx, 64, 64, donate=False,
                                     matmul_precision="float32")
    mesh = jmesh.make_mesh(4)
    p, st = jmesh.replicate(mesh, params), jmesh.replicate(mesh,
                                                          tx.init(params))
    losses = []
    for b in runs["yb"]:
        p, st, m = step(p, st, jmesh.shard_batch(mesh, b["images"]),
                        jmesh.shard_batch(mesh, b["truths"]))
        losses.append(float(m["loss"]))
    dp = runs["dp"]["yolo"]
    np.testing.assert_allclose(dp[0][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(dp[0][1], losses[1], rtol=1e-3)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in dp[2].items()})
    for i, (a, b) in enumerate(zip(p, port_yolo.params_to_jax(model))):
        for k in a:
            np.testing.assert_allclose(b[k], np.asarray(a[k]), rtol=0,
                                       atol=1e-3, err_msg=f"{i} {k}")


def test_averaged_yolo_gradients_fail_the_bar(runs):
    """The JAX loss is a sum over the batch over the global batch: a
    DDP-style mean of the ranks' gradients gives 1/4 of its update."""
    mean, single = runs["mean"], runs["single1"]
    np.testing.assert_allclose(mean[0][0], single[0][0], rtol=1e-5)
    worst = max(np.abs(mean[2][k] - single[2][k]).max() for k in mean[2])
    assert worst > 1e-3


def test_hgprm_first_loss_is_the_jax_loss_on_the_global_batch(runs):
    import jax
    from betapose_tpu.models import hgprm as jax_hg
    from betapose_tpu.train import kpd_train as jax_train
    params = jax_hg.torch_state_dict_to_params(
        {k: torch.from_numpy(v) for k, v in runs["hg_sd"].items()}, K,
        **HG)
    _, nhwc = runs["hb"][0]
    outs = jax.jit(lambda p, x: jax_hg.forward(
        p, x, all_heads=True, train=True))(params, nhwc["inps"])
    ref = sum(float(jax_train.masked_mse_loss(o, nhwc["labels"],
                                              nhwc["set_mask"]))
              for o in outs)
    np.testing.assert_allclose(runs["dp"]["hg"][0][0], ref, rtol=1e-4)


def test_train_kpd_main_on_two_ranks_gives_one_device_result(tmp_path):
    pytest.importorskip("cv2")
    pytest.importorskip("h5py")
    from tests.test_torch_kpd_train_cli import argv_for, make_tiny_kpd_data
    from betapose_tpu_torch.train import train_kpd_main
    from betapose_tpu_torch.core import checkpoint
    from betapose_tpu_torch.models import kpd as kpd_mod
    data = make_tiny_kpd_data(tmp_path, n_train=8)
    # a start with the batch norms away from zero (`away_from_zero`), in
    # float32 and with sgd (adam's first updates are near lr * sign(g),
    # which the rounding of a batch of 2 against one of 4 flips where g is
    # near 0)
    start = kpd_mod.FastPose(K, "resnet50")
    start.load_state_dict({k: torch.from_numpy(v) for k, v in
                           away_from_zero(_state(start), 2).items()})
    checkpoint.save_kpd_npz(str(tmp_path / "start.npz"), start)
    opt = ("--trainBatch", "4", "--optMethod", "sgd", "--LR", "1e-2",
           "--trainPrecision", "float32", "--snapshot", "0", "--loadModel",
           str(tmp_path / "start.npz"))
    one = train_kpd_main.main(argv_for(data, tmp_path, "one", "resnet50",
                                       extra=opt))
    two = train_kpd_main.main(argv_for(data, tmp_path, "two", "resnet50",
                                       extra=opt + ("--n_devices", "2")))
    for (k, a), b in zip(one.state_dict().items(),
                         two.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-3,
                                   err_msg=k)
    logs = [(tmp_path / "tb" / "coco" / e / "metrics.jsonl").read_text()
            for e in ("one", "two")]
    assert logs[0].count("Train/Loss") == logs[1].count("Train/Loss") == 2
    assert (tmp_path / "exp" / "coco" / "two" / "model_final.npz").exists()


def test_dryrun_multichip_four_ranks(runs):
    from betapose_tpu_torch import entry
    line = runs["dryrun"]
    assert line.startswith("dryrun_multichip(4): kpd_loss=")
    assert line.endswith("multi_cand_eval=ok spatial_eval=ok ok")
    fields = dict(f.split("=") for f in line.split()[1:] if "=" in f)
    kpd_batch, _, _, tp_batch, _, _ = entry.dryrun_inputs(4)
    _, ref = entry.dryrun_kpd_step(None, kpd_batch)
    _, tp_ref = entry.dryrun_kpd_step(None, tp_batch)
    np.testing.assert_allclose(float(fields["kpd_loss"]), ref, rtol=1e-5)
    np.testing.assert_allclose(float(fields["dpxtp_kpd_loss"]), tp_ref,
                               rtol=1e-5)
    assert np.isfinite(float(fields["yolo_loss"]))
