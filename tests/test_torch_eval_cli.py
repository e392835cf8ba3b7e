"""The port's evaluation CLI end to end on the CPU (`--device cpu`), on a
synthetic SIXD tree, the way tests/test_e2e_eval.py::TestEvalCLI drives the
JAX CLI: random weights (smoke mode), so the contract is checked, not the
accuracy."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("cv2")

from tests._synth import make_synthetic_sixd  # noqa: E402
from betapose_tpu_torch.data import loader as port_loader  # noqa: E402
from betapose_tpu_torch.eval import betapose_evaluate  # noqa: E402
from betapose_tpu_torch.models import yolov3 as yolo_mod  # noqa: E402
from betapose_tpu_torch.models.darknet_cfg import make_yolov3_cfg  # noqa: E402
from betapose_tpu_torch.native import loader as native_loader  # noqa: E402


def _argv(sixd, out, *extra):
    return ["--indir", os.path.join(sixd, "test", "01", "rgb"),
            "--outdir", out, "--obj_id", "1", "--sixd_base", sixd,
            "--detbatch", "2", "--inp_dim", "64", "--nClasses", "50",
            "--netType", "resnet50", "--inputResH", "64", "--inputResW", "32",
            "--outputResH", "16", "--outputResW", "8", "--conf", "0",
            "--device", "cpu", *extra]


def _zero_yolo_weights(path):
    """A YOLOv3 .weights file with every conv weight and bias zero: each
    row decodes to its anchor box at objectness 0.5, so the first row wins
    and every frame gets the same well-formed box.  (He-init random weights
    saturate through the 75 convs and give degenerate boxes.)"""
    spec = yolo_mod.build_spec(make_yolov3_cfg(num_classes=1, width=64,
                                               height=64))
    model = yolo_mod.Darknet(spec, 64)
    with torch.no_grad():
        for _, m in yolo_mod.conv_layers(model):
            m.conv.weight.zero_()
            if m.conv.bias is not None:
                m.conv.bias.zero_()
    yolo_mod.save_darknet_weights(model, path)
    return str(path)


def test_eval_cli_writes_results_and_metrics(tmp_path):
    sixd = make_synthetic_sixd(tmp_path, n_frames=3)
    out = str(tmp_path / "out")
    weights = _zero_yolo_weights(tmp_path / "zero.weights")
    stats = betapose_evaluate.main(_argv(sixd, out, "--profile",
                                         "--yolo_weights", weights))
    data = json.load(open(os.path.join(out, "Betapose-results.json")))
    assert isinstance(data, list) and len(data) == 3
    for d in data:
        assert len(d["cam_R"]) == 9 and len(d["cam_t"]) == 3
        assert len(d["keypoints"]) == 3 * 50
        assert np.isfinite(d["cam_R"] + d["cam_t"] + d["keypoints"]).all()
        assert np.isfinite(d["score"])
    assert set(stats) >= {"mean_add", "mean_2d_acc", "mean_iou", "fps"}


def test_eval_cli_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    sixd = make_synthetic_sixd(tmp_path, n_frames=1)
    out = str(tmp_path / "out")
    with pytest.raises(FileNotFoundError):
        betapose_evaluate.main(_argv(sixd, out, "--yolo_weights",
                                     str(tmp_path / "missing.weights")))
    # --host_loader native raises where the C++ loader cannot build (it
    # runs where it builds: test_eval_cli_feeds_give_the_same_results)
    with monkeypatch.context() as m:
        m.setattr(native_loader, "available", lambda: False)
        with pytest.raises(RuntimeError, match="C\\+\\+ loader unavailable"):
            betapose_evaluate.main(_argv(sixd, out, "--host_loader",
                                         "native"))
    # the multi-candidate path, refused before it was ported, now runs
    weights = _zero_yolo_weights(tmp_path / "zero.weights")
    stats = betapose_evaluate.main(_argv(sixd, out, "--det_capacity", "3",
                                         "--yolo_weights", weights))
    assert set(stats) >= {"mean_add", "mean_2d_acc", "mean_iou", "fps"}


HG_ARGS = ["--netType", "hgPRM", "--nFeats", "16", "--nStack", "1",
           "--baseWidth", "4", "--cardinality", "2", "--inputResW", "64",
           "--outputResW", "16"]


@pytest.mark.parametrize("weights", ["seeded", "npz"])
def test_eval_cli_serves_hgprm(tmp_path, capsys, weights):
    """--netType hgPRM serves PyraNet (as tests/test_e2e_eval.py's
    test_hgprm_eval_cli drives the JAX CLI; heatmap sides 16x16, multiples
    of the hourglass's 16): from a seeded init in smoke mode, or from a JAX
    `.npz` checkpoint given by --kpd_weights, without the smoke warning."""
    sixd = make_synthetic_sixd(tmp_path, n_frames=3)
    out = str(tmp_path / "out")
    extra = [*HG_ARGS, "--yolo_weights",
             _zero_yolo_weights(tmp_path / "zero.weights")]
    if weights == "npz":
        from betapose_tpu.core.checkpoint import save_pytree_npz
        from tests.test_torch_hgprm import random_hgprm_params
        path = str(tmp_path / "hg.npz")
        save_pytree_npz(path, random_hgprm_params(
            50, 0, n_feats=16, n_stack=1, base_width=4, cardinality=2))
        extra += ["--kpd_weights", path]
    stats = betapose_evaluate.main(_argv(sixd, out, *extra))
    printed = capsys.readouterr().out
    assert ("KPD weights" in printed and "smoke mode" in printed) == (
        weights == "seeded")
    if weights == "npz":
        assert f"Loading KPD weights from {path}" in printed
    # one entry per frame with a valid pose (the seeded init's heatmaps
    # give none)
    data = json.load(open(os.path.join(out, "Betapose-results.json")))
    assert len(data) == (3 if weights == "npz" else 0)
    for d in data:
        assert np.isfinite(d["cam_R"] + d["cam_t"] + d["keypoints"]).all()
    assert set(stats) >= {"mean_add", "mean_2d_acc", "mean_iou", "fps"}


def test_loader_threads_and_procs_give_the_same_padded_batches(tmp_path):
    sixd = make_synthetic_sixd(tmp_path, n_frames=5, img_shape=(24, 32))
    paths = port_loader.list_images(os.path.join(sixd, "test", "01", "rgb"))
    got = {}
    for mode in ("threads", "procs"):
        loader = port_loader.make_loader(paths, 2, mode=mode, workers=2)
        got[mode] = list(loader)
        assert loader.batch_sizes == [2, 2, 1]
    assert [b.shape for b in got["threads"]] == [(2, 24, 32, 3)] * 3
    for a, b in zip(got["threads"], got["procs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["threads"][2][1],
                                  got["threads"][2][0])   # padded tail


def test_eval_cli_feeds_give_the_same_results(tmp_path):
    """The CLI from PNG files through the C++ ring loader
    (`--host_loader native`), the cv2 threads and a `FrameCache` writes
    the same results JSON, byte for byte: every feed decodes the same
    pixels (native PNG decodes are cv2's, tests/test_torch_native_loader.py)."""
    if not native_loader.available():
        pytest.skip("the native loader cannot build here (no g++ or "
                    "libpng/libjpeg)")
    sixd = make_synthetic_sixd(tmp_path, n_frames=5)
    weights = _zero_yolo_weights(tmp_path / "zero.weights")
    got = {}
    for feed in ("native", "threads", "cache"):
        out = str(tmp_path / feed)
        argv = _argv(sixd, out, "--yolo_weights", weights, "--host_loader",
                     "threads" if feed == "cache" else feed)
        report = {}
        stats = betapose_evaluate.run_eval(
            argv, frame_cache=(str(tmp_path / "frames.npy")
                               if feed == "cache" else None), report=report)
        assert stats["fps"] > 0 and len(report["final_result"]) == 5
        with open(os.path.join(out, "Betapose-results.json"), "rb") as f:
            got[feed] = f.read()
    assert os.path.exists(tmp_path / "frames.npy.manifest.json")
    assert len(json.loads(got["native"])) == 5
    assert got["native"] == got["threads"] == got["cache"]
