"""The port's parallel building blocks (`betapose_tpu_torch/parallel/`) on
four gloo CPU ranks, in one spawn (`launch.run_ranks`):

- `make_mesh` gives the JAX `make_mesh`'s axes, names, sizes and order,
  for every split of four devices into data, space and model;
- `shard_params_tp` on a 2x2 (data, model) mesh: each rank's slice of each
  leaf (in torch layout) is the JAX shard of the same leaf on the same
  device, and indivisible leaves stay whole;
- `shard_batch` and `shard_frames` give each rank JAX's rows;
- the collectives' values and gradients (sum, mean, gather, copy_to);
- column-parallel layers (`layers.tensor_parallel`: Conv2d, Linear and a
  darknet ConvLayer with its batch norm) over a model group of 2: the
  output and input gradient are the whole network's, each rank's
  parameter gradients its slices of the whole network's;
- the three train-mode batch norms synchronized over the ranks (darknet's,
  FastPose's, PyraNet's): forward, input and parameter gradients, and
  running statistics equal the single-process batch norm on the global
  batch within 1e-5;
- spatial partitioning (`spatial.split_rows`) of FastPose and of a
  darknet with a shortcut, routes, an upsample and two yolo heads, over
  a space group of 4 and one of 2: at heights where every map splits,
  where the deeper ones do not, where an upsample goes from a whole map
  to a split one, and where the stem's halo outgrows a band, the output
  is the whole network's within 1e-4 relative;
- `run_ranks` raises a rank's exception in the caller.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

SPLITS = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (4, 1)]
LEAVES = {"conv": (3, 3, 16, 32), "vec": (32,), "odd": (3, 3, 16, 9),
          "dense": (8, 6), "bias_odd": (3,)}


def tp_leaves():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in LEAVES.items()}


def torch_layout(x):
    """HWIO -> OIHW, [in, out] -> [out, in]: the output channels first."""
    if x.ndim == 4:
        return x.transpose(3, 2, 0, 1)
    return x.T if x.ndim == 2 else x


BN_KINDS = ("darknet", "fastpose", "pyranet")


def bn_module(kind, c, seed):
    from betapose_tpu_torch.models import hgprm, kpd, yolov3
    bn = {"darknet": yolov3.BatchNorm2d, "fastpose": kpd.BatchNorm2d,
          "pyranet": hgprm.BatchNorm2d}[kind](c)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, c)))
    return bn.train()


def bn_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((8, 5, 6, 4)) * 2 + 1).astype(np.float32)
    g = rng.standard_normal((8, 5, 6, 4)).astype(np.float32)
    return x, g


def bn_run(kind, group=None, rows=slice(None)):
    """Forward, backward of sum(y * g) (on `rows` of the batch) and the
    running statistics after it."""
    from betapose_tpu_torch.parallel.layers import set_batch_norm_group
    bn = set_batch_norm_group(bn_module(kind, 5, 1), group)
    x, g = (torch.from_numpy(a[rows]) for a in bn_inputs(2))
    x.requires_grad_(True)
    y = bn(x)
    (y * g).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy().copy(),
            "var": bn.running_var.numpy().copy()}


def tp_net():
    """Convs, an SE-style linear and a darknet ConvLayer with its batch
    norm, each splittable over 2 ranks, and one (3 channels) that is not."""
    from betapose_tpu_torch.models import yolov3
    torch.manual_seed(0)
    layer = yolov3.ConvLayer(yolov3.LayerSpec(
        kind="conv", in_channels=6, out_channels=4, size=3, stride=1,
        pad=1, batch_normalize=True, activation="leaky"))
    return torch.nn.ModuleDict({
        "a": torch.nn.Conv2d(3, 8, 3, 2, 1), "b": torch.nn.Conv2d(8, 6, 1),
        "fc": torch.nn.Linear(6, 6), "c": layer,
        "d": torch.nn.Conv2d(4, 3, 3, 1, 1)})


def tp_run(group):
    """Forward and backward of sum(y * g) through `tp_net`, tensor-parallel
    over `group`; (y, dx, {parameter: its gradient, the rank's slice})."""
    from betapose_tpu_torch.parallel.layers import tensor_parallel
    net = tensor_parallel(tp_net().train(), group)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 6)).astype(
        np.float32)).requires_grad_(True)
    h = torch.relu(net["b"](torch.relu(net["a"](x))))
    h = h * torch.sigmoid(net["fc"](h.mean(dim=(2, 3))))[:, :, None, None]
    y = net["d"](net["c"](h))
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32))
    (y * g).sum().backward()
    grads = {n.replace(".inner", ""): p.grad.numpy().copy()
             for n, p in net.named_parameters()}
    return y.detach().numpy(), x.grad.numpy(), grads


SPLIT_YOLO_CFG = """
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
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
filters=18
activation=linear

[yolo]
mask = 3,4,5
anchors = 10,13,  16,30,  33,23,  30,61,  62,45,  59,119
classes=1
num=6

[route]
layers = -4

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers = -1, 0

[convolutional]
size=3
stride=1
pad=1
filters=18
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,13,  16,30,  33,23,  30,61,  62,45,  59,119
classes=1
num=6
"""
# (space group size, network, input height): FastPose crops are h x 32,
# darknet frames h x h
SPLIT_CASES = ((4, "kpd", 64), (4, "kpd", 48), (4, "kpd", 8),
               (4, "yolo", 40), (4, "yolo", 36), (2, "yolo", 36),
               (2, "kpd", 40))


def split_input(net, h):
    rng = np.random.default_rng(h)
    return torch.from_numpy(rng.random(
        (2, h, 32 if net == "kpd" else h, 3)).astype(np.float32))


def split_network(net, h):
    """FastPose (resnet50, 4 keypoints) or the darknet of SPLIT_YOLO_CFG
    at reso h, from a seed, batch norms away from the identity."""
    from betapose_tpu_torch.models import kpd, yolov3
    g = torch.Generator().manual_seed(5)
    if net == "kpd":
        model = kpd.FastPose(4, "resnet50", generator=g)
    else:
        model = yolov3.Darknet(yolov3.build_spec(SPLIT_YOLO_CFG), h, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return model.eval()


def split_run():
    """Every SPLIT_CASES network through `split_rows` on this rank."""
    from betapose_tpu_torch.parallel import mesh as mesh_mod
    from betapose_tpu_torch.parallel.spatial import Space, split_rows
    spaces = {n: Space(mesh_mod.axis_group(mesh_mod.make_mesh(
        4, spatial_parallel=n), "space")) for n in (2, 4)}
    with torch.no_grad():
        return {case: split_rows(split_network(*case[1:]), spaces[case[0]])(
                    split_input(*case[1:])).numpy() for case in SPLIT_CASES}


def _rank():
    import torch.distributed as dist
    from betapose_tpu_torch.parallel import collectives as coll
    from betapose_tpu_torch.parallel import mesh as mesh_mod
    r = dist.get_rank()
    out = {"shapes": {}, "coords": {}}
    for mp, sp in SPLITS:
        mesh = mesh_mod.make_mesh(4, model_parallel=mp, spatial_parallel=sp)
        out["shapes"][mp, sp] = (mesh.mesh_dim_names,
                                 tuple(mesh.mesh.shape),
                                 {a: mesh_mod.axis_size(mesh, a)
                                  for a in ("data", "space", "model")})
    mesh = mesh_mod.make_mesh(4, model_parallel=2)
    leaves = {k: torch.from_numpy(torch_layout(v))
              for k, v in tp_leaves().items()}
    out["tp"] = {k: v.numpy() for k, v in
                 mesh_mod.shard_params_tp(mesh, leaves).items()}
    batch = np.arange(8 * 6 * 2 * 1).reshape(8, 6, 2, 1)
    out["batch"] = mesh_mod.shard_batch(mesh, batch)
    smesh = mesh_mod.make_mesh(4, spatial_parallel=2)
    out["frames"] = mesh_mod.shard_frames(smesh, batch)

    # collectives over the data axis of the 2x2 mesh (ranks {0,2}, {1,3})
    grp = mesh_mod.axis_group(mesh, "data")
    x = torch.full((3,), float(r + 1), requires_grad=True)
    w = torch.arange(3.0) + 10 * r
    res = {}
    for name, fn in (("sum", coll.all_reduce_sum),
                     ("mean", coll.all_reduce_mean),
                     ("copy", coll.copy_to)):
        x.grad = None
        y = fn(x, grp)
        (y * w).sum().backward()
        res[name] = (y.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    y = coll.gather(x[None], 0, grp)            # [2, 3]
    (y * torch.arange(6.0).reshape(2, 3)).sum().backward()
    res["gather"] = (y.detach().numpy(), x.grad.numpy().copy())
    res["tp"] = tp_run(mesh_mod.axis_group(mesh, "model"))
    every = [None] * 4
    dist.all_gather_object(every, (out, res))
    # batch norms over all four ranks, two rows each
    world = mesh_mod.axis_group(mesh_mod.make_mesh(4), "data")
    bns = {k: bn_run(k, world, slice(2 * r, 2 * r + 2)) for k in BN_KINDS}
    every_bn = [None] * 4
    dist.all_gather_object(every_bn, bns)
    every_split = [None] * 4
    dist.all_gather_object(every_split, split_run())
    return every, every_bn, every_split


def _fails():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ArithmeticError("rank one fails")
    dist.barrier()


@pytest.fixture(scope="module")
def ranks():
    from betapose_tpu_torch.parallel import launch
    return launch.run_ranks(_rank, 4, "cpu")


def test_make_mesh_matches_jax(ranks):
    from betapose_tpu.parallel import mesh as jmesh
    every, *_ = ranks
    for mp, sp in SPLITS:
        jm = jmesh.make_mesh(4, model_parallel=mp, spatial_parallel=sp)
        names, shape, as_dict = every[0][0]["shapes"][mp, sp]
        assert names == jm.axis_names
        assert shape == tuple(jm.devices.shape)
        assert as_dict == {a: dict(jm.shape).get(a, 1)
                           for a in ("data", "space", "model")}


def test_shard_params_tp_is_the_jax_shard(ranks):
    import jax
    from betapose_tpu.parallel import mesh as jmesh
    every, *_ = ranks
    jm = jmesh.make_mesh(4, model_parallel=2)
    tree = jmesh.shard_params_tp(jm, tp_leaves())
    devices = jax.devices()[:4]
    for k, leaf in tree.items():
        shards = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for r in range(4):
            got = every[r][0]["tp"][k]
            np.testing.assert_array_equal(
                got, torch_layout(shards[devices[r]]), err_msg=f"{k} {r}")
    assert every[1][0]["tp"]["conv"].shape == (16, 16, 3, 3)
    assert every[1][0]["tp"]["odd"].shape == (9, 16, 3, 3)    # whole


def test_batch_and_frame_rows_are_jax_rows(ranks):
    import jax
    from betapose_tpu.parallel import mesh as jmesh
    every, *_ = ranks
    batch = np.arange(8 * 6 * 2 * 1).reshape(8, 6, 2, 1)
    for mesh_kw, key, fn in (
            (dict(model_parallel=2), "batch", jmesh.shard_batch),
            (dict(spatial_parallel=2), "frames", jmesh.shard_frames)):
        arr = fn(jmesh.make_mesh(4, **mesh_kw), batch)
        shards = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for r, d in enumerate(jax.devices()[:4]):
            np.testing.assert_array_equal(every[r][0][key], shards[d])


def test_collectives_values_and_gradients(ranks):
    every, *_ = ranks
    for r in range(4):
        res = every[r][1]
        peer = r ^ 2                       # the other rank of its group
        w = lambda q: np.arange(3.0) + 10 * q   # noqa: E731
        tot = float(r + 1 + peer + 1)
        np.testing.assert_array_equal(res["sum"][0], np.full(3, tot))
        np.testing.assert_array_equal(res["sum"][1], w(r) + w(peer))
        np.testing.assert_allclose(res["mean"][0], np.full(3, tot / 2))
        np.testing.assert_allclose(res["mean"][1], (w(r) + w(peer)) / 2)
        np.testing.assert_array_equal(res["copy"][0], np.full(3, r + 1.0))
        np.testing.assert_array_equal(res["copy"][1], w(r) + w(peer))
        lo, hi = sorted((r, peer))
        np.testing.assert_array_equal(
            res["gather"][0], [np.full(3, lo + 1.0), np.full(3, hi + 1.0)])
        np.testing.assert_array_equal(res["gather"][1],
                                      np.arange(3.0) + 3 * (r > peer))


def test_column_parallel_forward_and_backward(ranks):
    """Each rank of a model group of 2 holds half of every splittable
    layer: the output and the input gradient are the whole network's, and
    each rank's parameter gradients are its slices of the whole network's
    (the indivisible conv's whole)."""
    every, *_ = ranks
    y, dx, grads = tp_run(None)
    for r in range(4):
        ty, tdx, tgrads = every[r][1]["tp"]
        np.testing.assert_allclose(ty, y, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tdx, dx, rtol=1e-5, atol=1e-5)
        index = r % 2                       # this rank's place on "model"
        assert set(tgrads) == set(grads)
        for k, g in grads.items():
            n = tgrads[k].shape[0]
            part = g if n == g.shape[0] else g[index * n:(index + 1) * n]
            np.testing.assert_allclose(tgrads[k], part, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        assert tgrads["a.weight"].shape[0] == 4
        assert tgrads["d.weight"].shape[0] == 3


@pytest.mark.parametrize("kind", BN_KINDS)
def test_synchronized_batch_norm_is_the_global_batch_norm(ranks, kind):
    _, every_bn, _ = ranks
    ref = bn_run(kind)
    got = {k: np.concatenate([every_bn[r][kind][k] for r in range(4)])
           for k in ("y", "dx")}
    for k in ("y", "dx"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in ("dw", "db"):       # the loss sums the ranks' rows
        np.testing.assert_allclose(sum(every_bn[r][kind][k]
                                       for r in range(4)), ref[k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for r in range(4):
        for k in ("mean", "var"):
            np.testing.assert_allclose(every_bn[r][kind][k], ref[k],
                                       rtol=1e-5, err_msg=k)
    before = bn_module(kind, 5, 1)
    rolled = not np.allclose(ref["mean"], before.running_mean.numpy())
    assert rolled == (kind != "pyranet")


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=["-".join(map(str, c)) for c in SPLIT_CASES])
def test_split_rows_is_the_whole_network(ranks, case):
    *_, every_split = ranks
    with torch.no_grad():
        ref = split_network(*case[1:])(split_input(*case[1:])).numpy()
    for r in range(4):
        got = every_split[r][case]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_a_failing_rank_raises_in_the_caller():
    from betapose_tpu_torch.parallel import launch
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank 1 of 2 failed.*rank one"):
        launch.run_ranks(_fails, 2, "cpu")


def test_single_rank_group_runs_the_dp_step_exactly():
    """`launch.single_rank`: a world-1 group in this process (how
    chip_smoke.py runs the DP paths on the card), under which the DP
    train step is the single-process step, and which is gone after."""
    import torch.distributed as dist
    from betapose_tpu_torch import entry
    from betapose_tpu_torch.parallel import launch
    from betapose_tpu_torch.parallel import mesh as mesh_mod
    _, imgs, truths, _, _, _ = entry.dryrun_inputs(2)
    model, loss = entry.dryrun_yolo_step(None, imgs, truths)
    with launch.single_rank("cpu") as dev:
        assert dev.type == "cpu" and dist.get_world_size() == 1
        dp_model, dp_loss = entry.dryrun_yolo_step(mesh_mod.make_mesh(1),
                                                   imgs, truths)
    assert not dist.is_initialized()
    assert dp_loss == loss
    for (k, a), b in zip(model.state_dict().items(),
                         dp_model.state_dict().values()):
        assert torch.equal(a, b), k
