"""The port's multi-candidate path (`det_capacity > 1`) against the JAX
package's, on the CPU in float32 at small shapes, with the same parameters
and frames on both sides (weights through `yolov3.params_from_jax` and
`kpd.state_dict_from_jax`):

- `top_boxes` / `nms`: kept indices, masks and boxes equal to JAX,
  planted objectness ties and below-threshold rows included;
- `crop_from_dets` with N boxes per frame against the JAX per-frame crop;
- the whole capacity-3 step in both modes (device pose-NMS, host pose-NMS)
  and both preprocessings: boxes within 1e-3 px, det_valid and pose_valid
  equal;
- both multi post stages fed the same planted heatmaps and detections:
  keypoints and scores within rtol 1e-5, poses compared in metric space;
- the port's device mode against its host mode within the bars of
  tests/test_pipeline.py::TestMultiCandidate.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.eval import pipeline as jax_pipe  # noqa: E402
from betapose_tpu.geometry import metrics  # noqa: E402
from betapose_tpu.ops import boxes as jax_boxes  # noqa: E402
from betapose_tpu.ops import image as jax_image  # noqa: E402
from betapose_tpu_torch.core.profiling import RuntimeProfile  # noqa: E402
from betapose_tpu_torch.eval import pipeline as port_pipe  # noqa: E402
from betapose_tpu_torch.ops import boxes as port_boxes  # noqa: E402
from betapose_tpu_torch.ops import image as port_image  # noqa: E402
from betapose_tpu_torch.ops import pose_nms as port_pnms  # noqa: E402
from tests.test_torch_image_boxes import ATOL, _boxes  # noqa: E402
from tests.test_torch_pipeline import (CAM_K, KW, POST_SHAPE,  # noqa: E402
                                       _pose, jax_cfg, port_cfg)
from tests.test_torch_pipeline import setup  # noqa: E402,F401


def _predictions(kind, b=3, rows=300, seed=0):
    """Decoded-YOLO-like rows [B,rows,6] (cx, cy, w, h, obj, cls): clustered
    boxes so that NMS suppresses, in four flavours."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 80, (b, 5, 2))
    pick = rng.integers(0, 5, (b, rows))
    cxy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(
        0, 4, (b, rows, 2))
    wh = rng.uniform(8, 40, (b, rows, 2))
    obj = rng.uniform(0, 1, (b, rows))
    if kind == "ties":                    # the zero-weights CLI's rows
        obj[:] = 0.5
    elif kind == "bf16_ties":             # few distinct objectness values
        obj = np.round(obj * 8) / 8
    elif kind == "few_valid":             # most rows fail the threshold
        obj[:, 5:] = rng.uniform(0, 0.2, (b, rows - 5))
    cls = np.ones((b, rows, 1))
    return np.concatenate([cxy, wh, obj[..., None], cls], -1).astype(
        np.float32)


KINDS = ["random", "ties", "bf16_ties", "few_valid"]


@pytest.mark.parametrize("kind", KINDS)
def test_nms_matches_jax(kind):
    pred = _predictions(kind, seed=1)
    boxes = np.array(jax_boxes.xywh_to_xyxy(jnp.asarray(pred[..., :4])))
    scores = pred[..., 4]
    keep, mask = port_boxes.nms(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.4, 6)
    for b in range(len(pred)):
        rk, rm = jax_boxes.nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                               0.4, 6)
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(rk))
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(rm))


@pytest.mark.parametrize("capacity", [3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_top_boxes_matches_jax(kind, capacity):
    pred = _predictions(kind, seed=2)
    ref = jax_boxes.top_boxes(jnp.asarray(pred), 0.25, 0, capacity=capacity,
                              nms_thresh=0.4, prefilter=64)
    out = port_boxes.top_boxes(torch.from_numpy(pred), 0.25, 0,
                               capacity=capacity, nms_thresh=0.4, prefilter=64)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), k)
    if kind == "few_valid":               # 5 rows pass: padded slots invalid
        assert out["valid"].sum(1).max() <= 5


def test_top_boxes_tie_order_is_jax_order():
    """All rows at one objectness: the lowest rows win, in index order (what
    `jax.lax.top_k` gives and `torch.topk` does not promise)."""
    pred = _predictions("ties", b=1, seed=3)
    pred[0, :, :2] = np.arange(300)[:, None] * 50.0   # no overlaps
    out = port_boxes.top_boxes(torch.from_numpy(pred), 0.1, capacity=4)
    expect = np.asarray(jax_boxes.xywh_to_xyxy(jnp.asarray(pred[0, :4, :4])))
    np.testing.assert_array_equal(out["boxes"][0].numpy(), expect)


def test_crop_from_dets_n_boxes_per_frame_matches_jax():
    rng = np.random.default_rng(3)
    imgs = rng.random((2, 48, 64, 3), np.float32)
    boxes = _boxes(rng, 6, 48, 64).reshape(2, 3, 4)
    crops, pt1, pt2 = port_image.crop_from_dets(
        torch.from_numpy(imgs), torch.from_numpy(boxes), 32, 24)
    assert crops.shape == (2, 3, 32, 24, 3) and pt1.shape == (2, 3, 2)
    rc, r1, r2 = jax.vmap(lambda im, bx: jax_image.crop_from_dets(
        im, bx, 32, 24))(jnp.asarray(imgs), jnp.asarray(boxes))
    np.testing.assert_allclose(crops.numpy(), np.asarray(rc), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(pt1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(pt2.numpy(), np.asarray(r2))


def _jax_pipeline(setup, **kw):
    spec, yolo_params, kpd_params, _, _, kp3d, _ = setup
    return jax_pipe.PosePipeline(spec, yolo_params, kpd_params, kp3d, CAM_K,
                                 jax_cfg(**kw))


def _port_pipeline(setup, **kw):
    _, _, _, yolo, kpd, kp3d, _ = setup
    return port_pipe.PosePipeline(yolo, kpd, kp3d, CAM_K, port_cfg(**kw),
                                  device="cpu")


KEYS = {"boxes", "obj_score", "det_valid", "keypoints", "kp_scores",
        "proposal_score", "pose_valid", "cam_R", "cam_t"}


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("preproc", ["stretch", "letterbox"])
def test_whole_step_matches_jax(setup, preproc, host):
    frames = setup[-1]
    kw = dict(det_capacity=3, host_pose_nms=host, preproc=preproc)
    ref = {k: np.asarray(v) for k, v in
           _jax_pipeline(setup, **kw)(frames).items()}
    pipe = _port_pipeline(setup, **kw)
    out = pipe(frames)
    assert set(out) == set(ref) == KEYS
    for k, v in out.items():
        assert v.shape == ref[k].shape and torch.isfinite(v.float()).all(), k
    np.testing.assert_allclose(out["boxes"].numpy(), ref["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(out["det_valid"].numpy(), ref["det_valid"])
    np.testing.assert_array_equal(out["pose_valid"].numpy(),
                                  ref["pose_valid"])
    # the candidates themselves, before pose-NMS
    with torch.inference_mode():
        det = pipe.det_stage(pipe.yolo, pipe.to_device(frames))
    jdet = jax.jit(jax_pipe.make_det_stage(setup[0], jax_cfg(**kw)))(
        setup[1], jnp.asarray(frames))
    assert det["crops"].shape == (2 * 3, 64, 32, 3)
    np.testing.assert_allclose(det["boxes"].numpy(), np.asarray(jdet["boxes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(det["det_valid"].numpy(),
                                  np.asarray(jdet["det_valid"]))


def test_candidates_step_matches_jax(setup):
    """The device part of the host mode: per-candidate keypoints [B,N,...]
    before pose-NMS."""
    spec, yolo_params, kpd_params, _, _, _, frames = setup
    cfg = dict(det_capacity=3, host_pose_nms=True)
    ref = jax.jit(jax_pipe.make_candidates_step(spec, jax_cfg(**cfg)))(
        yolo_params, kpd_params, jnp.asarray(frames))
    pipe = _port_pipeline(setup, **cfg)
    with torch.inference_mode():
        out = port_pipe.make_candidates_step(pipe.cfg)(
            pipe.yolo, pipe.kpd, pipe.to_device(frames))
    assert set(out) == set(ref)
    assert out["kp2d"].shape == (2, 3, KW["n_kp"], 2)
    np.testing.assert_array_equal(out["det_valid"].numpy(),
                                  np.asarray(ref["det_valid"]))
    for k, atol in [("boxes", 1e-3), ("kp2d", 1e-3), ("kp_scores", 1e-4)]:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=atol, err_msg=k)


def _planted_candidates(kp3d, n=3, seed=0):
    """Two frames of n candidate crops around the projections of a known
    pose: each candidate's crop box is shifted and its peaks jittered, so
    pose-NMS merges a real cluster.  Frame 1's last slot is invalid."""
    rng = np.random.default_rng(seed)
    out_h, out_w = POST_SHAPE["out_h"], POST_SHAPE["out_w"]
    R = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]])
    t = np.array([0.01, -0.02, 0.7])
    uv = (CAM_K @ (kp3d @ R.T + t).T).T
    uv = uv[:, :2] / uv[:, 2:3]
    size_h = 4.0 * np.ceil(max(np.ptp(uv[:, 1]), 2 * np.ptp(uv[:, 0])) / 4
                           + 12)
    yy, xx = np.mgrid[0:out_h, 0:out_w]
    hms, pt1, pt2, boxes = [], [], [], []
    for _ in range(2):
        for j in range(n):
            ul = np.floor(uv.min(0) - 20.0) + [2.0 * j, -1.0 * j]
            xy = ((uv - ul) * out_h / size_h - 0.2
                  + rng.normal(0, 0.15, uv.shape))
            hm = np.exp(-((xx[None] - xy[:, 0, None, None]) ** 2
                          + (yy[None] - xy[:, 1, None, None]) ** 2) / 2.0)
            hms.append(hm * rng.uniform(0.6, 1.0))
            pt1.append(ul)
            pt2.append(ul + [size_h / 2, size_h])
            boxes.append(np.r_[uv.min(0), uv.max(0)] + rng.normal(0, 1, 4))
    det = {"boxes": np.reshape(boxes, (2, n, 4)).astype(np.float32),
           "obj_score": rng.uniform(0.3, 0.9, (2, n)).astype(np.float32),
           "det_valid": np.ones((2, n), bool),
           "pt1": np.asarray(pt1, np.float32),
           "pt2": np.asarray(pt2, np.float32)}
    det["det_valid"][1, -1] = False
    return np.asarray(hms, np.float32), det, (R, t)


POST_CASES = {
    "least_squares": {},
    "pruned_weighted_robust": dict(left_keypoints=10, pnp_score_power=4.0,
                                   pnp_robust_rounds=2),
    "spread_and_depth_prior": dict(pnp_spread_power=1.0,
                                   pnp_depth_prior=0.05),
}


@pytest.mark.parametrize("case", sorted(POST_CASES))
def test_multi_post_stages_agree_on_the_same_heatmaps(case):
    rng = np.random.default_rng(5)
    kp3d = (rng.standard_normal((20, 3)) * 0.05).astype(np.float32)
    hm, det, truth = _planted_candidates(kp3d)
    kw = {"n_kp": 20, "left_keypoints": 20, "det_capacity": 3, **POST_SHAPE,
          **POST_CASES[case]}
    ref = jax_pipe.make_multi_post_stage(jax_cfg(**kw))(
        jnp.asarray(hm), {k: jnp.asarray(v) for k, v in det.items()},
        jnp.asarray(kp3d), jnp.asarray(CAM_K))
    out = port_pipe.make_multi_post_stage(port_cfg(**kw))(
        torch.from_numpy(hm), {k: torch.from_numpy(v) for k, v in det.items()},
        torch.from_numpy(kp3d), torch.from_numpy(CAM_K))
    assert set(out) == KEYS
    for k in ("pose_valid", "det_valid", "boxes", "obj_score"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), k)
    assert out["pose_valid"].all()
    for k in ("keypoints", "kp_scores", "proposal_score"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, err_msg=k)
    for b in range(2):
        pj = _pose(np.asarray(ref["cam_R"][b]), np.asarray(ref["cam_t"][b]))
        pp = _pose(out["cam_R"][b].numpy(), out["cam_t"][b].numpy())
        assert metrics.add_err(pj, pp, kp3d) < 1e-4
        if "pnp_depth_prior" not in kw:   # the prior pulls t_z off truth
            assert metrics.add_err(_pose(*truth), pp, kp3d) < 1e-2


@pytest.fixture(scope="module")
def tiny_multi(setup):
    """The bars' configuration (tests/test_pipeline.py::TestMultiCandidate):
    reso 96, crops 64x48, heatmaps 16x12, 4 frames of 120x160."""
    frames = np.random.default_rng(3).integers(0, 255, (4, 120, 160, 3),
                                               dtype=np.uint8)
    kw = dict(reso=96, inp_h=64, inp_w=48, out_h=16, out_w=12,
              det_capacity=3)
    return frames, kw


def test_device_mode_matches_host_mode(setup, tiny_multi):
    frames, kw = tiny_multi
    dev = _port_pipeline(setup, **kw)
    host = _port_pipeline(setup, host_pose_nms=True, **kw)
    od = port_pipe.to_numpy(dev(frames))
    oh = port_pipe.to_numpy(host(frames))
    np.testing.assert_array_equal(oh["pose_valid"], od["pose_valid"])
    np.testing.assert_array_equal(oh["det_valid"], od["det_valid"])
    for k, atol in [("keypoints", 1e-2), ("kp_scores", 1e-4),
                    ("proposal_score", 1e-3), ("boxes", 1e-2),
                    ("obj_score", 1e-4)]:
        np.testing.assert_allclose(oh[k], od[k], rtol=1e-3, atol=atol,
                                   err_msg=k)
    for i in np.flatnonzero(oh["pose_valid"]):
        np.testing.assert_allclose(oh["cam_t"][i], od["cam_t"][i], rtol=1e-2,
                                   atol=1e-3)


def test_host_mode_clusters_several_candidates(setup, tiny_multi,
                                               monkeypatch):
    frames, kw = tiny_multi
    seen = []
    real = port_pnms.pose_nms

    def spy(bboxes, *args, **kwargs):
        seen.append(len(bboxes))
        return real(bboxes, *args, **kwargs)

    monkeypatch.setattr(port_pipe.pnms, "pose_nms", spy)
    out = _port_pipeline(setup, host_pose_nms=True, **kw)(frames[:2])
    assert seen and max(seen) > 1
    assert out["keypoints"].shape == (2, KW["n_kp"], 2)
    assert out["cam_t"].shape == (2, 3) and out["det_valid"].all()


def test_spread_power_with_host_mode_raises(setup, tiny_multi):
    frames, kw = tiny_multi
    pipe = _port_pipeline(setup, host_pose_nms=True, pnp_spread_power=1.0,
                          **kw)
    with pytest.raises(ValueError, match="pnp_spread_power"):
        pipe(frames[:1])


@pytest.mark.parametrize("host", [False, True])
def test_profiled_call_and_run_batches(setup, tiny_multi, host):
    frames, kw = tiny_multi
    pipe = _port_pipeline(setup, host_pose_nms=host, **kw)
    ref = pipe(frames)
    prof = RuntimeProfile()
    out = pipe.profiled_call(frames, prof)
    assert all(len(prof.buckets[b]) == 1 for b in ("dt", "pt", "pn"))
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    results = pipe.run_batches(iter([frames, frames[:1], frames]))
    assert [len(r["boxes"]) for r in results] == [4, 1, 4]
    for k in ref:
        np.testing.assert_array_equal(results[2][k], ref[k].numpy())


def test_out_of_memory_halves_the_batch_in_host_mode(setup, tiny_multi,
                                                     monkeypatch):
    frames, kw = tiny_multi
    pipe = _port_pipeline(setup, host_pose_nms=True, **kw)
    ref = pipe(frames)
    det_stage = pipe.det_stage
    sizes = []

    def tight(model, batch):
        sizes.append(len(batch))
        if len(batch) > 2:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return det_stage(model, batch)

    monkeypatch.setattr(pipe, "det_stage", tight)
    out = pipe(frames)
    assert sizes == [4, 2, 2]
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
