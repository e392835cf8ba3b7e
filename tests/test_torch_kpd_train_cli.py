"""The port's KPD training CLI (`betapose_tpu_torch.train.train_kpd_main`)
on the CPU, on the tiny h5 + PNG dataset of tests/test_kpd_train_cli.py:

- resnet50 and resnet101 train, snapshot and validate, write model_0.npz,
  optimizer.npz, option.json, model_final.npz and metrics.jsonl, and
  resume with --Continue from the latest snapshot;
- the JAX package's `load_kpd_checkpoint` reads the port's
  model_final.npz, and its forward gives the port module's heatmaps
  within 1e-4 relative; the same for hgPRM, whose snapshot holds
  calibrated batch-norm statistics;
- --loadModel starts from a checkpoint, --symPerms trains;
- the optimizer state crosses both ways: after one epoch of the JAX
  trainer (rmsprop), the port's --Continue resumes its optimizer.npz and
  the port's next update is the JAX trainer's next update (within 1e-3 of
  the largest parameter update, the bar of tests/test_torch_kpd_train.py);
  the JAX loader reads the port's optimizer.npz; a file with a missing
  key raises;
- an unknown --netType, an --n_devices that does not split --trainBatch
  and a --symPerms row that is not a permutation raise.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.core import checkpoint as jax_ckpt  # noqa: E402
from betapose_tpu.models import hgprm as jax_hg  # noqa: E402
from betapose_tpu.models import kpd as jax_kpd  # noqa: E402
from betapose_tpu.train import kpd_train as jax_train  # noqa: E402
from betapose_tpu_torch.train import train_kpd_main  # noqa: E402


@pytest.fixture
def tiny_kpd_data(tmp_path):
    return make_tiny_kpd_data(tmp_path)


def make_tiny_kpd_data(tmp_path, n_train=6):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("h5py")
    from betapose_tpu_torch.data.annot import write_annot_h5
    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    for split, n in (("train", n_train), ("eval", 3)):
        (root / split).mkdir(parents=True)
        names, bbs, parts = [], [], []
        for i in range(n):
            name = "%012d.png" % i
            img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
            cv2.imwrite(str(root / split / name), img)
            names.append(name)
            bbs.append(np.array([[30.0, 20.0, 130.0, 100.0]]))
            parts.append(rng.uniform(40, 95, (4, 2)))
        write_annot_h5(str(root / f"annot_{split}.h5"), names,
                       np.stack(bbs), np.stack(parts))
    return str(root)


def argv_for(data, tmp_path, exp, net, res=(64, 32), extra=()):
    return ["--expID", exp, "--nClasses", "4", "--netType", net,
            "--optMethod", "adam", "--trainBatch", "3", "--validBatch", "3",
            "--nEpochs", "1", "--snapshot", "1", "--valid_every", "1",
            "--inputResH", str(res[0]), "--inputResW", str(res[1]),
            "--outputResH", str(res[0] // 4),
            "--outputResW", str(res[1] // 4), "--addDPG", "1",
            "--annot_dir", data, "--img_dir", data,
            "--exp_root", str(tmp_path / "exp"),
            "--tb_root", str(tmp_path / "tb"),
            "--n_devices", "1", "--device", "cpu", *extra]


def port_heatmaps(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("net", ["resnet50", "resnet101"])
def test_train_cli_runs_resumes_and_loads_in_jax(tiny_kpd_data, tmp_path,
                                                 net):
    argv = argv_for(tiny_kpd_data, tmp_path, "t", net)
    final = train_kpd_main.main(argv)
    exp_dir = tmp_path / "exp" / "coco" / "t"
    for name in ("model_0.npz", "optimizer.npz", "option.json",
                 "model_final.npz"):
        assert (exp_dir / name).exists(), name
    assert json.loads((exp_dir / "option.json").read_text())["netType"] == net
    lines = (tmp_path / "tb" / "coco" / "t" / "metrics.jsonl").read_text()
    tags = {json.loads(ln)["tag"] for ln in lines.splitlines()}
    assert tags == {"Train/Loss", "Train/Acc", "Valid/Loss", "Valid/Acc"}
    # the optimizer state is written in the JAX trainer's layout
    tx = jax_train.make_optimizer("adam", params_example=jax_kpd.init_params(
        jax.random.PRNGKey(0), 4, net))
    with np.load(exp_dir / "optimizer.npz") as opt:
        assert set(opt.files) == jax_state_keys(tx, 4, net)

    # the JAX package reads the port's checkpoint; same heatmaps
    params = jax_ckpt.load_kpd_checkpoint(str(exp_dir / "model_final.npz"),
                                          4, net)
    x = np.random.default_rng(1).normal(0, 0.5, (2, 64, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jax_kpd.forward)(params, jnp.asarray(x)))
    got = port_heatmaps(final, x)
    np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())

    # --Continue resumes from model_0 and the optimizer state
    train_kpd_main.main(argv + ["--Continue", "1", "--nEpochs", "2"])
    assert (exp_dir / "model_1.npz").exists()
    with np.load(exp_dir / "optimizer.npz") as opt:
        assert int(opt[".inner_state[0].count"]) == 4


def test_train_cli_hgprm_loads_in_jax(tiny_kpd_data, tmp_path):
    net = ["--nStack", "1", "--nFeats", "16", "--baseWidth", "4",
           "--cardinality", "2"]
    argv = argv_for(tiny_kpd_data, tmp_path, "hg", "hgPRM", (128, 64), net)
    final = train_kpd_main.main(argv)
    exp_dir = tmp_path / "exp" / "coco" / "hg"
    assert (exp_dir / "model_0.npz").exists()
    kw = dict(n_feats=16, n_stack=1, base_width=4, cardinality=2)
    params = jax_ckpt.load_kpd_checkpoint(str(exp_dir / "model_final.npz"),
                                          4, "hgPRM", **kw)
    # PyraNet trains without rolling its statistics: the snapshot's are
    # calibrated on the last batch, not the init's identity
    assert np.abs(np.asarray(params["bn1"]["var"]) - 1).max() > 1e-3
    x = np.random.default_rng(2).normal(0, 0.5, (2, 128, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jax_hg.forward)(params, jnp.asarray(x)))
    got = port_heatmaps(final, x)
    np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_load_model_and_sym_perms(tiny_kpd_data, tmp_path):
    first = train_kpd_main.main(argv_for(tiny_kpd_data, tmp_path, "a",
                                         "resnet50"))
    ckpt = str(tmp_path / "exp" / "coco" / "a" / "model_final.npz")
    perm = tmp_path / "perm.txt"
    perm.write_text("1,0,3,2\n")
    # no epoch to run: the loaded network is the final one
    again = train_kpd_main.main(argv_for(
        tiny_kpd_data, tmp_path, "b", "resnet50",
        extra=("--loadModel", ckpt, "--nEpochs", "0",
               "--symPerms", str(perm))))
    for (k, a), b in zip(first.state_dict().items(),
                         again.state_dict().values()):
        assert k.endswith("num_batches_tracked") or torch.equal(a, b), k
    train_kpd_main.main(argv_for(tiny_kpd_data, tmp_path, "c", "resnet50",
                                 extra=("--symPerms", str(perm))))
    assert os.path.exists(tmp_path / "exp" / "coco" / "c" /
                          "model_final.npz")


def test_unknown_nettype_and_devices_rejected(tmp_path):
    with pytest.raises(ValueError, match="netType"):
        train_kpd_main.main(["--netType", "hourglass",
                             "--annot_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="split evenly"):
        train_kpd_main.main(["--n_devices", "4", "--trainBatch", "6",
                             "--annot_dir", str(tmp_path)])


def test_load_sym_perms(tmp_path):
    perm = np.array([1, 0, 3, 2])
    npy = tmp_path / "p.npy"
    np.save(npy, perm)
    (p,) = train_kpd_main.load_sym_perms(str(npy), 4)
    np.testing.assert_array_equal(p, perm)
    txt = tmp_path / "p.txt"
    txt.write_text("1,0,3,2\n2, 3, 0, 1\n")
    p1, p2 = train_kpd_main.load_sym_perms(str(txt), 4)
    np.testing.assert_array_equal(p1, perm)
    np.testing.assert_array_equal(p2, [2, 3, 0, 1])
    for bad, content in (("bad.txt", "0,0,1,2\n"), ("short.txt", "1,0,2\n")):
        (tmp_path / bad).write_text(content)
        with pytest.raises(ValueError, match="permutation"):
            train_kpd_main.load_sym_perms(str(tmp_path / bad), 4)


def jax_state_keys(tx, n_kp, net):
    state = tx.init(jax_kpd.init_params(jax.random.PRNGKey(0), n_kp, net))
    return {jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]}


def test_continue_resumes_the_jax_optimizer_state(tiny_kpd_data, tmp_path):
    """One epoch of the JAX trainer with rmsprop (momentum 0.9, weight
    decay 1e-4); then the port's --Continue state and the JAX trainer's
    take the same next update on one batch."""
    from betapose_tpu.train import train_kpd_main as jax_main
    from betapose_tpu_torch.train import kpd_train as port_train
    from test_torch_kpd_train import make_batch

    opt = ["--optMethod", "rmsprop", "--momentum", "0.9",
           "--weightDecay", "1e-4", "--trainPrecision", "float32"]
    argv = [a for a in argv_for(tiny_kpd_data, tmp_path, "j", "resnet50")
            if a not in ("--device", "cpu")]
    i = argv.index("--optMethod")
    argv = argv[:i] + argv[i + 2:] + opt
    jax_main.main(argv)
    exp_dir = tmp_path / "exp" / "coco" / "j"

    # batch-norm scales and biases away from the init's 1 and 0, as
    # tests/test_torch_kpd_train.py draws them: at the init's, float32
    # rounding flips ReLUs and no two float32 runs agree to 1e-3 of an
    # rmsprop update
    rng = np.random.default_rng(0)
    snap = dict(np.load(exp_dir / "model_0.npz"))
    for k in snap:
        if "bn" in k and k.endswith(("['scale']", "['bias']")):
            lo, hi = (0.1, 0.3) if k.endswith("['scale']") else (0.5, 1.5)
            snap[k] = rng.uniform(lo, hi, snap[k].shape).astype(np.float32)
    np.savez(exp_dir / "model_0.npz", **snap)

    # the JAX trainer's next update, from its own files
    params = jax_ckpt.load_kpd_checkpoint(str(exp_dir / "model_0.npz"), 4,
                                          "resnet50")
    tx = jax_train.make_optimizer("rmsprop", 2.5e-4, 0.9, 1e-4,
                                  params_example=params)
    state = jax_ckpt.load_pytree_npz(str(exp_dir / "optimizer.npz"),
                                     tx.init(params))
    port_batch, jax_batch = make_batch(5)
    step = jax_train.make_train_step(tx, out_res_h=16, donate=False,
                                     matmul_precision="float32")
    after, _, _ = step(params, state, jax_batch)

    # the port's, from the same files through --Continue
    args = train_kpd_main.parse_args(
        argv_for(tiny_kpd_data, tmp_path, "j", "resnet50")[2:] + opt
        + ["--Continue", "1"])
    net = train_kpd_main.build_network(args)
    optimizer, start = train_kpd_main.start_state(args, net, str(exp_dir))
    assert start == 1
    assert all(len(st) == 3 for st in optimizer.state.values())   # nu, trace
    with np.load(exp_dir / "optimizer.npz") as arrays:
        back = optimizer.jax_named_state(net.model, net.to_tree)
        assert set(back) == set(arrays.files)
        for k in back:
            np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    port_train.make_train_step(net.model, optimizer, 16, "float32")(
        port_batch)
    got = port_train.trainable_leaves(
        jax_kpd.torch_state_dict_to_params(net.model.state_dict(), 4,
                                           "resnet50"))
    p0 = dict(port_train.trainable_leaves(params))
    ref = dict(port_train.trainable_leaves(after))
    biggest = max(np.abs(np.asarray(ref[k]) - np.asarray(p0[k])).max()
                  for k in ref)
    assert biggest > 1e-4
    worst = max(np.abs(np.asarray(v) - np.asarray(ref[k])).max()
                for k, v in got)
    assert worst <= 1e-3 * biggest, (worst, biggest)

    # the whole CLI resumes from the JAX directory
    train_kpd_main.main(argv_for(tiny_kpd_data, tmp_path, "j", "resnet50")
                        + opt + ["--Continue", "1", "--nEpochs", "2"])
    assert (exp_dir / "model_1.npz").exists()
    # and the JAX loader reads what the port wrote back, value for value
    back = jax_ckpt.load_pytree_npz(str(exp_dir / "optimizer.npz"),
                                    tx.init(params))
    with np.load(exp_dir / "optimizer.npz") as arrays:
        for k, v in jax.tree_util.tree_flatten_with_path(back)[0]:
            np.testing.assert_array_equal(
                np.asarray(v), arrays[jax.tree_util.keystr(k)])


def test_continue_rejects_an_incomplete_optimizer_state(tiny_kpd_data,
                                                        tmp_path):
    argv = argv_for(tiny_kpd_data, tmp_path, "m", "resnet50")
    train_kpd_main.main(argv)
    path = tmp_path / "exp" / "coco" / "m" / "optimizer.npz"
    with np.load(path) as arrays:
        full = dict(arrays)
    for drop in (".inner_state[0].nu['conv1']['w']",
                 ".inner_state[0].count"):
        np.savez(path, **{k: v for k, v in full.items() if k != drop})
        with pytest.raises(KeyError, match="missing"):
            train_kpd_main.main(argv + ["--Continue", "1"])
    np.savez(path, **full, extra=np.zeros(1))
    with pytest.raises(KeyError, match="unknown"):
        train_kpd_main.main(argv + ["--Continue", "1"])
    # the port's own older layout still reads, and a gap in it raises
    net = train_kpd_main.build_network(train_kpd_main.parse_args(argv))
    opt = __import__("betapose_tpu_torch.train.kpd_train",
                     fromlist=["x"]).make_optimizer(
        net.model.parameters(), "adam")
    own = {f"{slot}/{n}": (np.int64(2) if slot == "count" else
                          np.zeros(tuple(p.shape), np.float32))
           for n, p in net.model.named_parameters()
           for slot in ("count", "mu", "nu")}
    opt.load_named_state(own, net.model)
    assert all(st["count"] == 2 for st in opt.state.values())
    own.pop("mu/conv_out.bias")
    with pytest.raises(KeyError, match="missing"):
        opt.load_named_state(own, net.model)
