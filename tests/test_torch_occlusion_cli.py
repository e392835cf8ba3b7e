"""The port's occlusion evaluation CLI and video demo on the CPU
(`--device cpu`), on a synthetic SIXD tree, the way
tests/test_e2e_eval.py drives the JAX CLIs: random or all-zero weights, so
the contract is checked, not the accuracy.  The occlusion metric loop is
held against the JAX function on the same results."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from betapose_tpu.eval import occlusion_betapose_evaluate as jax_occ  # noqa: E402
from betapose_tpu_torch.data import sixd as sixd_mod  # noqa: E402
from betapose_tpu_torch.eval import occlusion_betapose_evaluate as occ  # noqa: E402
from betapose_tpu_torch.eval import results as results_mod  # noqa: E402
from betapose_tpu_torch.eval import video_demo  # noqa: E402
from tests._synth import make_synthetic_sixd  # noqa: E402
from tests.test_torch_eval_cli import _argv, _zero_yolo_weights  # noqa: E402


@pytest.fixture
def occl_sixd(tmp_path):
    """A synthetic tree whose scene 02 (the occlusion GT scene) is scene
    01."""
    sixd = make_synthetic_sixd(tmp_path, n_frames=3)
    os.symlink(os.path.join(sixd, "test", "01"),
               os.path.join(sixd, "test", "02"))
    return sixd


@pytest.mark.parametrize("mode", ["device", "host"])
def test_occlusion_cli_multi_candidate(occl_sixd, tmp_path, mode):
    out = str(tmp_path / "out")
    extra = ["--left_keypoints", "10", "--det_capacity", "3",
             "--pnp_robust", "2", "--pnp_score_power", "4",
             "--yolo_weights", _zero_yolo_weights(tmp_path / "zero.weights")]
    if mode == "host":
        extra.append("--host_pose_nms")
    stats = occ.main(_argv(occl_sixd, out, *extra))
    data = json.load(open(os.path.join(out, "Betapose-results.json")))
    assert isinstance(data, list) and len(data) == 3
    for d in data:
        assert len(d["cam_R"]) == 9 and len(d["cam_t"]) == 3
        assert np.isfinite(d["cam_R"] + d["cam_t"] + d["keypoints"]).all()
    assert set(stats) >= {"mean_add", "mean_2d_acc", "mean_iou", "fps",
                          "mean_add_err", "add_metric"}


def _final_result(sixd):
    """Results built from the GT of scene 02: an exact pose, a pose 5 cm
    off, a frame with no result and a box that misses (IoU < 0.5)."""
    frames = sixd_mod.load_sixd(sixd, seq=2, nr_frames=0).frames
    out = []
    for i, shift in enumerate([0.0, 0.05, None]):
        _, pose, bb = frames[i].gt[0]
        name = f"{i:04d}.png"
        if shift is None:
            out.append(results_mod.make_frame_result(name, [], [], []))
            continue
        box = np.array([bb[0], bb[1], bb[0] + bb[2], bb[1] + bb[3]], float)
        res = [{"bbox": box, "keypoints": np.zeros((50, 2)),
                "kp_score": np.ones((50, 1)), "proposal_score": 1.0}]
        t = pose[:3, 3] + shift
        out.append(results_mod.make_frame_result(
            name, res, pose[:3, :3], t.reshape(3, 1)))
    miss = dict(out[0], imgname="0001.png")
    miss["result"] = [dict(miss["result"][0], bbox=np.array(
        [0.0, 0.0, 20.0, 20.0]))]
    return out + [miss]


@pytest.mark.parametrize("symmetric", [False, True])
def test_occlusion_metrics_match_jax(occl_sixd, symmetric):
    final = _final_result(occl_sixd)
    verts = np.random.default_rng(0).uniform(-0.04, 0.04, (300, 3))
    ref = jax_occ.evaluate_occlusion_metrics(final, occl_sixd, 1, verts, 10,
                                             symmetric=symmetric)
    out = occ.evaluate_occlusion_metrics(final, occl_sixd, 1, verts, 10,
                                         symmetric=symmetric)
    assert set(out) == set(ref)
    for k in ref:
        if isinstance(ref[k], float):
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-12, err_msg=k)
        else:
            assert out[k] == ref[k], k
    assert 0 < out["mean_add"] < 1 and out["mean_iou"] == pytest.approx(2 / 3)


def test_video_demo_writes_one_result_per_frame(occl_sixd, tmp_path):
    video = str(tmp_path / "in.avi")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"XVID"), 10,
                         (64, 64))
    rng = np.random.default_rng(1)
    for _ in range(6):
        frame = rng.integers(0, 60, (64, 64, 3), dtype=np.uint8)
        frame[20:40, 16:36] = 220
        wr.write(frame)
    wr.release()
    out = str(tmp_path / "out")
    argv = _argv(occl_sixd, out, "--video", video, "--save_video",
                 "--det_capacity", "2", "--yolo_weights",
                 _zero_yolo_weights(tmp_path / "zero.weights"))
    argv[argv.index("--detbatch") + 1] = "4"      # a padded last batch
    results = video_demo.main(argv)
    assert len(results) == 6
    for r in results:
        assert set(r) == {"boxes", "pose_valid", "cam_R", "cam_t"}
        assert r["boxes"].shape == (4,) and r["cam_t"].shape == (3,)
    assert os.path.getsize(os.path.join(out, "render.avi")) > 0
