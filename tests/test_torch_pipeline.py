"""The PyTorch port's capacity-1 pose step against the JAX package's
(`betapose_tpu/eval/pipeline.py` `make_pose_step`), on the CPU in float32
at small shapes (reso 64, crop 64x32, heatmap 16x8, confidence 0), with the
same parameters and frames on both sides.

- boxes agree to atol 1e-3 px and det_valid is equal;
- heatmaps agree to rtol 1e-4;
- both post stages, fed the SAME heatmaps and detections, give exactly
  equal keypoints and scores, and poses that agree in metric space;
- with net_type="hgPRM" (PyraNet, crop 64x64, heatmap 16x16) the whole
  step agrees with the JAX step: det_valid and the decoded heatmap peaks
  equal, keypoints to 1e-3 px, poses in ADD.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.eval import pipeline as jax_pipe  # noqa: E402
from betapose_tpu.geometry import metrics  # noqa: E402
from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu_torch.core.profiling import RuntimeProfile  # noqa: E402
from betapose_tpu_torch.eval import pipeline as port_pipe  # noqa: E402
from betapose_tpu_torch.models import kpd as port_kpd  # noqa: E402
from betapose_tpu_torch.models import yolov3 as port_yolo  # noqa: E402
from betapose_tpu_torch.models import hgprm as port_hg  # noqa: E402
from tests.test_torch_hgprm import port_model, random_hgprm_params  # noqa: E402
from tests.test_torch_kpd import random_kpd_params  # noqa: E402

TINY_YOLO_CFG = """
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

[shortcut]
from=-1
activation=linear

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

[route]
layers = -3

[upsample]
stride=2

[route]
layers = -1, 2

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

N_KP = 6
CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]], np.float32)
KW = dict(reso=64, inp_h=64, inp_w=32, out_h=16, out_w=8, n_kp=N_KP,
          left_keypoints=N_KP, compute_dtype="float32", confidence=0.0)


def jax_cfg(**kw):
    return jax_pipe.PipelineConfig(**{**KW, **kw}, pallas_decode=False,
                                   s2d_stem=False)


def port_cfg(**kw):
    return port_pipe.PipelineConfig(**{**KW, **kw})


@pytest.fixture(scope="module")
def setup():
    spec = jax_yolo.build_spec(TINY_YOLO_CFG)
    rng = np.random.default_rng(0)
    # folded YOLO params ({"w" HWIO, "b"} per conv), drawn with numpy
    yolo_params = [
        {"w": jnp.asarray(rng.standard_normal(
            (l.size, l.size, l.in_channels, l.out_channels))
            * np.sqrt(2.0 / (l.size ** 2 * l.in_channels)), jnp.float32),
         "b": jnp.asarray(rng.normal(0, 0.1, l.out_channels), jnp.float32)}
        if l.kind == "conv" else {} for l in spec.layers]
    kpd_params = random_kpd_params(N_KP, "resnet50", 1)
    yolo = port_yolo.params_from_jax(
        port_yolo.build_spec(TINY_YOLO_CFG),
        [{k: np.asarray(v) for k, v in p.items()} for p in yolo_params], 64)
    kpd = port_kpd.FastPose(N_KP, "resnet50")
    kpd.load_state_dict(port_kpd.state_dict_from_jax(kpd_params))
    kp3d = (rng.standard_normal((N_KP, 3)) * 0.05).astype(np.float32)
    frames = rng.integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    return spec, yolo_params, kpd_params, yolo, kpd, kp3d, frames


@pytest.mark.parametrize("preproc", ["stretch", "letterbox"])
def test_whole_step_matches_jax(setup, preproc):
    spec, yolo_params, kpd_params, yolo, kpd, kp3d, frames = setup
    cfg = jax_cfg(preproc=preproc)
    det = jax.jit(jax_pipe.make_det_stage(spec, cfg))(yolo_params,
                                                       jnp.asarray(frames))
    hm = jax.jit(jax_pipe.make_pose_stage(cfg))(kpd_params, det["crops"])

    pipe = port_pipe.PosePipeline(yolo, kpd, kp3d, CAM_K,
                                  port_cfg(preproc=preproc), device="cpu")
    out = pipe(frames)
    with torch.inference_mode():
        p_det = pipe.det_stage(pipe.yolo, pipe.to_device(frames))
        p_hm = pipe.pose_stage(pipe.kpd, p_det["crops"])

    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(det["boxes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out["det_valid"].numpy(),
                                  np.asarray(det["det_valid"]))
    ref_hm = np.asarray(hm)
    np.testing.assert_allclose(p_hm.numpy(), ref_hm, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_hm).max())
    assert set(out) == {"boxes", "obj_score", "det_valid", "keypoints",
                        "kp_scores", "proposal_score", "pose_valid",
                        "cam_R", "cam_t"}
    for k, v in out.items():
        assert v.shape[0] == 2 and torch.isfinite(v.float()).all(), k


POST_SHAPE = dict(inp_h=512, inp_w=256, out_h=128, out_w=64)


def _planted_post_inputs(kp3d):
    """Heatmaps whose peaks sit at the projections of a known pose, and the
    detection that maps them back to image pixels.  The maps are 128x64 so
    that a heatmap pixel is ~2 image pixels and the planted pose is
    recoverable."""
    cfg = POST_SHAPE
    R = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]])
    t = np.array([0.01, -0.02, 0.7])
    pc = kp3d @ R.T + t
    uv = (CAM_K @ pc.T).T
    uv = uv[:, :2] / uv[:, 2:3]
    # crop box with the network's aspect: image = hm * size_h/out_h + ul
    ul = np.floor(uv.min(0) - 20.0)
    size_h = 4.0 * np.ceil(max(np.ptp(uv[:, 1]), 2 * np.ptp(uv[:, 0])) / 4
                           + 12)
    br = ul + [size_h / 2, size_h]
    xy = (uv - ul) * cfg["out_h"] / size_h - 0.2           # heatmap coords
    yy, xx = np.mgrid[0:cfg["out_h"], 0:cfg["out_w"]]
    hm = np.exp(-((xx[None] - xy[:, 0, None, None]) ** 2
                  + (yy[None] - xy[:, 1, None, None]) ** 2) / 2.0)
    hm = np.stack([hm, hm * 0.9]).astype(np.float32)        # [2,K,H,W]
    # the detection box is the keypoints' own extent (what the depth prior
    # reads); the crop corners pt1/pt2 are the padded crop
    box = np.r_[uv.min(0), uv.max(0)]
    det = {"boxes": np.tile(box, (2, 1)).astype(np.float32),
           "obj_score": np.array([0.9, 0.4], np.float32),
           "det_valid": np.array([True, False]),
           "pt1": np.tile(ul, (2, 1)).astype(np.float32),
           "pt2": np.tile(br, (2, 1)).astype(np.float32)}
    return hm, det, (R, t)


def _pose(R, t):
    p = np.eye(4)
    p[:3, :3] = R
    p[:3, 3] = np.ravel(t)
    return p


POST_CASES = {
    "least_squares": {},
    "pruned_weighted_robust": dict(left_keypoints=14, pnp_score_power=2.0,
                                   pnp_robust_rounds=1),
    "spread_and_depth_prior": dict(pnp_spread_power=1.0,
                                   pnp_depth_prior=0.05),
}


@pytest.mark.parametrize("case", sorted(POST_CASES))
def test_post_stages_agree_on_the_same_heatmaps(case):
    rng = np.random.default_rng(5)
    kp3d = (rng.standard_normal((20, 3)) * 0.05).astype(np.float32)
    hm, det, truth = _planted_post_inputs(kp3d)
    kw = {"n_kp": 20, "left_keypoints": 20, **POST_SHAPE, **POST_CASES[case]}
    ref = jax_pipe.make_post_stage(jax_cfg(**kw))(
        jnp.asarray(hm), {k: jnp.asarray(v) for k, v in det.items()},
        jnp.asarray(kp3d), jnp.asarray(CAM_K))
    out = port_pipe.make_post_stage(port_cfg(**kw))(
        torch.from_numpy(hm), {k: torch.from_numpy(v) for k, v in det.items()},
        torch.from_numpy(kp3d), torch.from_numpy(CAM_K))
    for k in ("keypoints", "kp_scores", "pose_valid", "det_valid", "boxes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), k)
    np.testing.assert_allclose(out["proposal_score"].numpy(),
                               np.asarray(ref["proposal_score"]), rtol=1e-6)
    for b in range(2):
        pj = _pose(np.asarray(ref["cam_R"][b]), np.asarray(ref["cam_t"][b]))
        pp = _pose(out["cam_R"][b].numpy(), out["cam_t"][b].numpy())
        assert metrics.add_err(pj, pp, kp3d) < 1e-4
        if "pnp_depth_prior" not in kw:   # the prior pulls t_z off truth
            assert metrics.add_err(_pose(*truth), pp, kp3d) < 1e-2


def test_flip_tta_matches_jax(setup):
    _, _, kpd_params, _, kpd, _, _ = setup
    crops = np.random.default_rng(4).random((2, 64, 32, 3), np.float32)
    ref = np.asarray(jax.jit(jax_pipe.make_pose_stage(jax_cfg(
        flip_tta=True)))(kpd_params, jnp.asarray(crops)))
    with torch.no_grad():
        out = port_pipe.make_pose_stage(port_cfg(flip_tta=True))(
            kpd, torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_profiled_call_and_run_batches(setup):
    _, _, _, yolo, kpd, kp3d, frames = setup
    pipe = port_pipe.PosePipeline(yolo, kpd, kp3d, CAM_K, port_cfg(),
                                  device="cpu")
    prof = RuntimeProfile()
    out = pipe.profiled_call(frames, prof)
    assert all(len(prof.buckets[b]) == 1 for b in ("dt", "pt", "pn"))
    ref = pipe(frames)
    for k in out:
        assert torch.equal(out[k], ref[k]), k
    results = pipe.run_batches(iter([frames, frames[:1], frames]))
    assert [len(r["boxes"]) for r in results] == [2, 1, 2]
    np.testing.assert_array_equal(results[2]["keypoints"],
                                  ref["keypoints"].numpy())


def test_out_of_memory_halves_the_batch(setup, monkeypatch):
    """On CUDA out-of-memory the batch is split in half and retried (the
    reference's OOM fallback); the halves' outputs are concatenated."""
    _, _, _, yolo, kpd, kp3d, frames = setup
    pipe = port_pipe.PosePipeline(yolo, kpd, kp3d, CAM_K, port_cfg(),
                                  device="cpu")
    halves = [pipe(frames[:1]), pipe(frames[1:])]
    ref = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
    det_stage = pipe.det_stage
    sizes = []

    def tight(model, batch):
        sizes.append(len(batch))
        if len(batch) > 1:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return det_stage(model, batch)

    monkeypatch.setattr(pipe, "det_stage", tight)
    out = pipe(frames)
    assert sizes == [2, 1, 1]
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_pipeline_needs_cuda_unless_cpu_is_asked_for(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    _, _, _, yolo, kpd, kp3d, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pipe.PosePipeline(yolo, kpd, kp3d, CAM_K, port_cfg())


HG_CROP = dict(inp_w=64, out_w=16)     # heatmap sides multiples of 16
HG_NET = dict(n_feats=16, n_stack=2)


@pytest.mark.parametrize("option", [
    dict(det_capacity=3), dict(host_pose_nms=True), dict(net_type="hgPRM")])
def test_options_outside_the_slice_raise(setup, option):
    """The options outside the first slice now run: det_capacity=3 through
    `make_pose_step`; host_pose_nms=True, which with capacity 1 runs the
    capacity-1 step (as in the JAX package); net_type="hgPRM", PyraNet at
    a 64x64 crop, through both as well."""
    _, _, _, yolo, kpd, kp3d, frames = setup
    if option.get("net_type") == "hgPRM":
        option = {**option, **HG_CROP}
        kpd = port_hg.PyraNet(N_KP, n_stack=1, n_feats=16,
                              generator=torch.Generator().manual_seed(3))
    pipe = port_pipe.PosePipeline(yolo, kpd, kp3d, CAM_K, port_cfg(**option),
                                  device="cpu")
    step = port_pipe.make_pose_step(pipe.cfg)
    with torch.inference_mode():
        out = step(pipe.yolo, pipe.kpd, pipe.to_device(frames), pipe.kp3d,
                   pipe.cam_K)
    ref = pipe(frames)
    assert set(out) == set(ref) and out["boxes"].shape == (2, 4)
    for k in out:
        assert torch.equal(out[k], ref[k]), k


def test_hgprm_step_matches_jax(setup):
    """The hgPRM pose step in float32 against the JAX step
    (`pallas_decode=False`) on the same parameters and frames.  Random
    weights give random keypoints, whose PnP pose is ill-conditioned (tens
    of metres away), so the poses are compared in metric space by the 2D
    reprojection of the keypoint model and by ADD relative to the
    distance."""
    spec, yolo_params, _, yolo, _, kp3d, frames = setup
    hg_params = random_hgprm_params(N_KP, 6, **HG_NET)
    cfg = dict(net_type="hgPRM", flip_tta=True, **HG_CROP)
    ref = jax.jit(jax_pipe.make_pose_step(spec, jax_cfg(**cfg)))(
        yolo_params, hg_params, jnp.asarray(frames), jnp.asarray(kp3d),
        jnp.asarray(CAM_K))
    jax_det = jax.jit(jax_pipe.make_det_stage(spec, jax_cfg(**cfg)))(
        yolo_params, jnp.asarray(frames))
    jax_hm = np.asarray(jax.jit(jax_pipe.make_pose_stage(jax_cfg(**cfg)))(
        hg_params, jax_det["crops"]))

    pipe = port_pipe.PosePipeline(yolo, port_model(hg_params, **HG_NET),
                                  kp3d, CAM_K, port_cfg(**cfg), device="cpu")
    out = pipe(frames)
    with torch.inference_mode():
        hm = pipe.pose_stage(pipe.kpd, pipe.det_stage(
            pipe.yolo, pipe.to_device(frames))["crops"]).numpy()
    assert hm.shape == (2, N_KP, 16, 16) and hm.dtype == np.float32
    np.testing.assert_allclose(hm, jax_hm, rtol=1e-4,
                               atol=1e-4 * np.abs(jax_hm).max())
    flat = hm.reshape(2 * N_KP, -1)
    np.testing.assert_array_equal(flat.argmax(1),
                                  jax_hm.reshape(2 * N_KP, -1).argmax(1))
    np.testing.assert_array_equal(out["det_valid"].numpy(),
                                  np.asarray(ref["det_valid"]))
    np.testing.assert_allclose(out["keypoints"].numpy(),
                               np.asarray(ref["keypoints"]), rtol=0,
                               atol=1e-3)
    for b in range(2):
        pj = _pose(np.asarray(ref["cam_R"][b]), np.asarray(ref["cam_t"][b]))
        pp = _pose(out["cam_R"][b].numpy(), out["cam_t"][b].numpy())
        assert metrics.projection_error_2d(pj, pp, kp3d, CAM_K) < 0.05
        assert metrics.add_err(pj, pp, kp3d) < 1e-3 * np.linalg.norm(pj[:3, 3])


def test_config_fields_mirror_jax():
    port_fields = {f.name for f in dataclasses.fields(port_pipe.PipelineConfig)}
    jax_fields = {f.name for f in dataclasses.fields(jax_pipe.PipelineConfig)}
    assert port_fields == jax_fields - {"pallas_decode"}
    assert port_pipe.PipelineConfig().s2d_stem is False
