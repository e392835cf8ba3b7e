"""The port's YOLO training CLI (`betapose_tpu_torch.tools.darknet_cli
detector train`, `train/train_yolo_main.py`) and its copy of
`tools/yolo_data_prep.py`, on the CPU, on the tiny dataset of
tests/test_darknet_cli.py (six 64x64 frames, one bright square each):

- snapshots `net_<it>.weights` and `net_final.weights` with darknet's
  `seen`; resuming from a snapshot starts at seen // batch with the LR
  schedule fast-forwarded there, and `-clear` starts at 0;
- with random=1 the port draws the same resolutions, iteration by
  iteration, as the JAX CLI on the same data;
- the port's `net_final.weights` loads in the JAX `load_darknet_weights`,
  and the JAX forward gives the port's eval heads within 1e-5 relative;
  a JAX `net_final.weights` resumes in the port at its `seen`;
- the CLI parses darknet's flags, `-gpus 0,1` trains on two ranks to the
  one-device result (parameters within 1e-3, seen counting the global
  batch), the verbs still to port raise, and without `-device cpu` it
  wants CUDA;
- the copied `yolo_data_prep` writes byte-identical label, list, .names
  and .data files to the JAX one on a synthetic SIXD tree.
"""

import os
import re

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu.tools import yolo_data_prep as jax_prep  # noqa: E402
from betapose_tpu.train import train_yolo_main as jax_main  # noqa: E402
from betapose_tpu_torch.models import yolov3 as port_yolo  # noqa: E402
from betapose_tpu_torch.tools import darknet_cli  # noqa: E402
from betapose_tpu_torch.tools import yolo_data_prep as port_prep  # noqa: E402
from betapose_tpu_torch.train import train_yolo_main  # noqa: E402
from betapose_tpu_torch.train import yolo_train  # noqa: E402

TINY_NET_CFG = """
[net]
batch=4
subdivisions=1
width=64
height=64
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.001
burn_in=4
max_batches=3
policy=steps
steps=100
scales=.1
random=0

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
jitter=.3
ignore_thresh = .7
random=0
"""


@pytest.fixture
def tiny_dataset(tmp_path):
    """6 images with a bright square at a known box + darknet labels."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        img = rng.integers(0, 60, (64, 64, 3), dtype=np.uint8)
        x, y = 16 + 4 * i % 20, 20 + 3 * i % 18
        img[y:y + 20, x:x + 20] = 220
        p = str(img_dir / f"{i:04d}.png")
        cv2.imwrite(p, img)
        cx, cy, w, h = (x + 10) / 64, (y + 10) / 64, 20 / 64, 20 / 64
        with open(str(img_dir / f"{i:04d}.txt"), "w") as f:
            f.write(f"0 {cx} {cy} {w} {h}\n")
        paths.append(p)
    lst = tmp_path / "all.txt"
    with open(lst, "w") as f:
        f.writelines(p + "\n" for p in paths)
    names = tmp_path / "obj.names"
    names.write_text("thing\n")
    data = tmp_path / "obj.data"
    data.write_text(
        f"classes = 1\ntrain = {lst}\nvalid = {lst}\n"
        f"names = {names}\nbackup = {tmp_path / 'backup'}\n")
    cfg = tmp_path / "net.cfg"
    cfg.write_text(TINY_NET_CFG)
    random_cfg = tmp_path / "rnd.cfg"
    random_cfg.write_text(TINY_NET_CFG.replace("random=0\n\n[conv",
                                               "random=1\n\n[conv", 1))
    return {"data": str(data), "cfg": str(cfg), "random_cfg":
            str(random_cfg), "dir": tmp_path, "paths": paths,
            "backup": tmp_path / "backup"}


def _log(text):
    """[(iteration, reso)] of the trainer's per-iteration log lines."""
    return [(int(a), int(b)) for a, b in
            re.findall(r"^(\d+): \S+, \S+ avg, reso (\d+),", text, re.M)]


@pytest.fixture
def counted_optimizers(monkeypatch):
    """The optimizers the trainer makes, kept for the test to read."""
    made = []
    orig = yolo_train.make_optimizer

    def make(model, cfg):
        made.append(orig(model, cfg))
        return made[-1]

    monkeypatch.setattr(yolo_train, "make_optimizer", make)
    return made


def test_snapshots_and_resume_from_seen(tiny_dataset, capsys,
                                        counted_optimizers):
    d = tiny_dataset
    train_yolo_main.train_from_data_cfg(
        d["data"], d["cfg"], None, snapshot_every=2, max_batches=3, batch=4,
        device="cpu")
    assert sorted(os.listdir(d["backup"])) == ["net_2.weights",
                                               "net_final.weights"]
    for name, seen in (("net_2.weights", 12), ("net_final.weights", 12)):
        _, header = port_yolo.load_darknet_weights(
            port_yolo.build_spec(TINY_NET_CFG), str(d["backup"] / name))
        assert int(header[3]) == seen, name
    assert [i for i, _ in _log(capsys.readouterr().out)] == [0, 1, 2]
    assert counted_optimizers[-1].count == 3

    # resume: seen 12 at batch 2 is iteration 6, the LR schedule there
    train_yolo_main.train_from_data_cfg(
        d["data"], d["cfg"], str(d["backup"] / "net_final.weights"),
        snapshot_every=0, max_batches=8, batch=2, device="cpu")
    out = capsys.readouterr().out
    assert "Resuming from" in out and "(seen=12)" in out
    assert [i for i, _ in _log(out)] == [6, 7]
    opt = counted_optimizers[-1]
    assert opt.count == 8
    assert opt.param_groups[0]["lr"] == float(opt.schedule(7))
    assert float(opt.schedule(7)) > 0.0          # past burn-in's lr(0) = 0

    # -clear: from iteration 0 with the same weights
    train_yolo_main.train_from_data_cfg(
        d["data"], d["cfg"], str(d["backup"] / "net_final.weights"),
        clear=True, snapshot_every=0, max_batches=2, batch=2, device="cpu")
    assert [i for i, _ in _log(capsys.readouterr().out)] == [0, 1]
    assert counted_optimizers[-1].count == 2


def test_weights_cross_with_the_jax_cli(tiny_dataset, capsys,
                                        counted_optimizers):
    """The same data and random=1 cfg through both CLIs: the same reso per
    iteration; each package's net_final.weights read by the other."""
    d = tiny_dataset
    jax_main.train_from_data_cfg(d["data"], d["random_cfg"], None,
                                 snapshot_every=0, max_batches=21, batch=2,
                                 n_devices=1)
    jax_log = _log(capsys.readouterr().out)
    jax_final = d["backup"] / "rnd_final.weights"
    os.rename(jax_final, d["dir"] / "jax_final.weights")

    model = train_yolo_main.train_from_data_cfg(
        d["data"], d["random_cfg"], None, snapshot_every=0, max_batches=21,
        batch=2, device="cpu")
    port_log = _log(capsys.readouterr().out)
    assert len(jax_log) == 21 and port_log == jax_log
    assert len({r for _, r in jax_log}) == 2          # both buckets drawn

    # the port's snapshot in the JAX package: the same eval heads
    spec = jax_yolo.build_spec(open(d["random_cfg"]).read())
    params, header = jax_yolo.load_darknet_weights(spec, str(jax_final))
    assert int(header[3]) == 42
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    ref = jax_yolo.forward(spec, params, jnp.asarray(x), 64, decode=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), decode=False)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())

    # the JAX snapshot resumes in the port at its seen (42 // 2 = 21)
    train_yolo_main.train_from_data_cfg(
        d["data"], d["random_cfg"], str(d["dir"] / "jax_final.weights"),
        snapshot_every=0, max_batches=23, batch=2, device="cpu")
    out = capsys.readouterr().out
    assert "(seen=42)" in out and [i for i, _ in _log(out)] == [21, 22]
    assert counted_optimizers[-1].count == 23


def test_cli_flags(tiny_dataset, capsys):
    d = tiny_dataset
    model = darknet_cli.main(["detector", "train", d["data"], d["cfg"],
                              "-clear", "-gpus", "0", "-resize_buckets", "1",
                              "-precision", "float32", "-device", "cpu"])
    assert isinstance(model, port_yolo.Darknet) and not model.training
    assert [i for i, _ in _log(capsys.readouterr().out)] == [0, 1, 2]
    assert os.path.exists(d["backup"] / "net_final.weights")
    assert darknet_cli.read_data_cfg(d["data"])["classes"] == "1"
    # two ranks (data parallel, batch 4 split 2 + 2) give what one gives
    two = darknet_cli.main(["detector", "train", d["data"], d["cfg"],
                            "-clear", "-gpus", "0,1", "-resize_buckets", "1",
                            "-precision", "float32", "-device", "cpu"])
    assert isinstance(two, port_yolo.Darknet) and not two.training
    for (k, a), b in zip(model.state_dict().items(),
                         two.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-3,
                                   err_msg=k)
    with open(d["backup"] / "net_final.weights", "rb") as f:
        assert np.frombuffer(f.read(16), np.int32)[3] == 3 * 4   # seen
    # the detector verbs run (an explicit weights path must exist); the
    # verbs still to port name their ROADMAP slice
    with pytest.raises(FileNotFoundError, match="not found"):
        darknet_cli.main(["detector", "map", d["data"], d["cfg"], "w",
                          "-device", "cpu"])
    for verb, where in ((["partial", d["cfg"], "w", "o", "74"], 5),
                        (["classifier", "train", d["data"], d["cfg"]], 7),
                        (["rnn", "train", d["cfg"]], 7),
                        (["nightmare", d["cfg"], "w", "img", "10"], 7)):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP slice {where}"):
            darknet_cli.main(verb)
    assert isinstance(darknet_cli.main([]), darknet_cli.CliError)


def test_default_device_is_cuda(tiny_dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would train")
    with pytest.raises(RuntimeError, match="CUDA"):
        darknet_cli.main(["detector", "train", tiny_dataset["data"],
                          tiny_dataset["cfg"]])


@pytest.fixture
def synthetic_sixd_test(tmp_path):
    """Minimal <sixd>/test tree for data prep (tests/test_darknet_cli.py's,
    with more frames and two objects in one)."""
    base = tmp_path / "sixd" / "test"
    for seq in (1, 2):
        seq_s = "%02d" % seq
        (base / seq_s / "rgb").mkdir(parents=True)
        gts = {}
        for i in range(12):
            img = np.zeros((480, 640, 3), np.uint8)
            cv2.imwrite(str(base / seq_s / "rgb" / f"{i:04d}.png"), img)
            gts[i] = [{"obj_id": seq,
                       "obj_bb": [100 + 3 * i, 120 + i, 200 - i, 150 + 2 * i],
                       "cam_R_m2c": [float(v) for v in np.eye(3).reshape(-1)],
                       "cam_t_m2c": [[0.0], [0.0], [600.0]]}]
            if i % 3 == 0:
                gts[i].append({"obj_id": 5, "obj_bb": [7, 9, 33, 41],
                               "cam_R_m2c": [1.0] * 9,
                               "cam_t_m2c": [[0.0], [0.0], [1.0]]})
        with open(base / seq_s / "gt.yml", "w") as f:
            yaml.safe_dump(gts, f)
    return str(base)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_yolo_data_prep_is_byte_identical(synthetic_sixd_test, tmp_path,
                                          mode, capsys):
    out = str(tmp_path / "dk")
    argv = ["--sixd_base", synthetic_sixd_test, "--out", out, "--mode",
            mode, "--ratio", "0.5", "--seed", "3"]
    jax_prep.main(argv)
    ref = _tree(out)
    os.rename(out, out + "_jax")
    port_prep.main(argv)
    got = _tree(out)
    assert set(got) == set(ref)
    assert got == ref
    lists = [k for k in ref if k.endswith("all.txt")]
    assert lists and all(ref[k] for k in lists)
    assert capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        port_prep.main(["--help"])
    assert e.value.code == 0
