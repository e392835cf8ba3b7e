"""The port's `parallel/inference.ShardedPosePipeline` on four gloo CPU
ranks, against the JAX package's `ShardedPosePipeline` on a mesh of the
same shape (`n_devices=4`, of the 8 virtual CPU devices) and against the
port's own single-process `PosePipeline`, at small shapes (reso 64, crop
64x32, heatmap 16x8), float32, the same networks and frames everywhere:

- data parallel (DP4, batch 8), DP2 x tensor parallel 2 (batch 4), one
  frame's rows over 4 ranks (space4), DP2 x space2 (batch 4), and the
  multi-candidate step with device pose-NMS over DP4 (capacity 3);
- against `PosePipeline`: boxes within 1e-3 px, det_valid and pose_valid
  equal, keypoint scores (heatmap peaks) within 1e-4 relative, keypoints
  within 1e-3 px, poses within 1e-4 in ADD and 1e-2 degrees;
- against JAX: boxes within 1e-3 px, det_valid equal, keypoint scores
  within 1e-4 relative (the bars of tests/test_torch_pipeline.py), and,
  where both packages decode the same peak (keypoints within 1e-3 px),
  poses within 1e-3 of their depth in ADD and 0.1 degrees (the random
  networks' poses lie tens of metres away, where float32 PnP turns 1e-3
  px into ~1e-4 of the depth);
- PyraNet (hgPRM, nFeats 16, nStack 1, 64x64 crops) over DP2 x TP2 and
  DP2 x space2 (where it runs whole) against `PosePipeline`, at the same
  bars;
- under tensor parallelism each rank holds half of a layer's output
  channels; the host pose-NMS mode raises.

The ranks run in one spawn (`parallel/launch.run_ranks`); the rank body
imports no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

N_KP = 6
CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]], np.float32)
KW = dict(reso=64, inp_h=64, inp_w=32, out_h=16, out_w=8, n_kp=N_KP,
          left_keypoints=N_KP, compute_dtype="float32", confidence=0.0)
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
# name: (model_parallel, spatial_parallel, det_capacity, batch, seed)
CASES = {"dp4": (1, 1, 1, 8, 1), "dp2_tp2": (2, 1, 1, 4, 2),
         "space4_b1": (1, 4, 1, 1, 3), "dp2_space2": (1, 2, 1, 4, 4),
         "multi_dp4": (1, 1, 3, 8, 2)}


def port_networks(yolo_layers, kpd_sd):
    from betapose_tpu_torch.models import kpd as port_kpd
    from betapose_tpu_torch.models import yolov3 as port_yolo
    yolo = port_yolo.params_from_jax(port_yolo.build_spec(TINY_YOLO_CFG),
                                     yolo_layers, 64)
    kpd = port_kpd.FastPose(N_KP, "resnet50")
    kpd.load_state_dict({k: torch.from_numpy(v) for k, v in kpd_sd.items()})
    return yolo, port_kpd.fold_bn(kpd)


def frames_of(case):
    *_, b, seed = CASES[case]
    return np.random.default_rng(seed).integers(0, 255, (b, 48, 64, 3),
                                                dtype=np.uint8)


def cfg_of(case):
    from betapose_tpu_torch.eval.pipeline import PipelineConfig
    return PipelineConfig(**KW, det_capacity=CASES[case][2])


HG_CASES = ((2, 1), (1, 2))     # DP2 x TP2, DP2 x space2, batch 4


def hgprm_network():
    from betapose_tpu_torch.models import hgprm
    return hgprm.PyraNet(N_KP, n_feats=16, n_stack=1,
                         generator=torch.Generator().manual_seed(2))


def hgprm_cfg():
    from betapose_tpu_torch.eval.pipeline import PipelineConfig
    return PipelineConfig(**{**KW, "inp_w": 64, "out_w": 16},
                          net_type="hgPRM")


def _rank(yolo_layers, kpd_sd, kp3d):
    """Every case on this rank; rank 0 returns the outputs as numpy."""
    from betapose_tpu_torch.parallel.inference import ShardedPosePipeline
    yolo, kpd = port_networks(yolo_layers, kpd_sd)
    outs, shapes = {}, {}
    for case, (mp, sp, *_rest) in CASES.items():
        pipe = ShardedPosePipeline(yolo, kpd, kp3d, CAM_K, cfg_of(case),
                                   model_parallel=mp, spatial_parallel=sp,
                                   device="cpu")
        outs[case] = {k: v.numpy() for k, v in pipe(frames_of(case)).items()}
        if sp == 1:
            conv = pipe.kpd.preact.conv1
            shapes[case] = tuple((conv.inner if mp > 1 else conv).weight.shape)
    # PyraNet (hgPRM): column-parallel, and whole over `space`
    hg = hgprm_network()
    for mp, sp in HG_CASES:
        pipe = ShardedPosePipeline(yolo, hg, kp3d, CAM_K, hgprm_cfg(),
                                   model_parallel=mp, spatial_parallel=sp,
                                   device="cpu")
        outs["hgprm", mp, sp] = {k: v.numpy() for k, v in
                                 pipe(frames_of("dp2_tp2")).items()}
    try:
        ShardedPosePipeline(yolo, kpd, kp3d, CAM_K, dataclasses.replace(
            cfg_of("multi_dp4"), host_pose_nms=True), device="cpu")
        raised = ""
    except ValueError as e:
        raised = str(e)
    return outs, shapes, raised


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp
    from betapose_tpu.eval import pipeline as jax_pipe
    from betapose_tpu.models import yolov3 as jax_yolo
    from betapose_tpu.parallel.inference import ShardedPosePipeline
    from betapose_tpu_torch.eval import pipeline as port_pipe
    from betapose_tpu_torch.models import kpd as port_kpd
    from betapose_tpu_torch.parallel import launch
    from tests.test_torch_kpd import random_kpd_params

    spec = jax_yolo.build_spec(TINY_YOLO_CFG)
    rng = np.random.default_rng(0)
    yolo_layers = [
        {"w": (rng.standard_normal(
            (l.size, l.size, l.in_channels, l.out_channels))
            * np.sqrt(2.0 / (l.size ** 2 * l.in_channels))
        ).astype(np.float32),
         "b": rng.normal(0, 0.1, l.out_channels).astype(np.float32)}
        if l.kind == "conv" else {} for l in spec.layers]
    kpd_params = random_kpd_params(N_KP, "resnet50", 1)
    kpd_sd = {k: v.numpy() for k, v in
              port_kpd.state_dict_from_jax(kpd_params).items()}
    kp3d = (rng.standard_normal((N_KP, 3)) * 0.05).astype(np.float32)

    outs, shapes, raised = launch.run_ranks(_rank, 4, "cpu", yolo_layers,
                                            kpd_sd, kp3d)
    yolo, kpd = port_networks(yolo_layers, kpd_sd)
    single, ref = {}, {}
    jax_yolo_params = [{k: jnp.asarray(v) for k, v in p.items()}
                       for p in yolo_layers]
    for case, (mp, sp, cap, _, _) in CASES.items():
        pipe = port_pipe.PosePipeline(yolo, kpd, kp3d, CAM_K, cfg_of(case),
                                      device="cpu")
        single[case] = {k: v.numpy() for k, v in
                        pipe(frames_of(case)).items()}
        jcfg = jax_pipe.PipelineConfig(**KW, det_capacity=cap,
                                       pallas_decode=False, s2d_stem=False)
        jpipe = ShardedPosePipeline(spec, jax_yolo_params, kpd_params, kp3d,
                                    CAM_K, jcfg, n_devices=4,
                                    model_parallel=mp, spatial_parallel=sp)
        ref[case] = {k: np.asarray(v) for k, v in
                     jpipe(frames_of(case)).items()}
    single["hgprm"] = {k: v.numpy() for k, v in port_pipe.PosePipeline(
        yolo, hgprm_network(), kp3d, CAM_K, hgprm_cfg(), device="cpu")(
        frames_of("dp2_tp2")).items()}
    assert jax.device_count() >= 4
    return outs, single, ref, shapes, raised, kp3d


def _pose(out, b):
    p = np.eye(4)
    p[:3, :3] = out["cam_R"][b]
    p[:3, 3] = out["cam_t"][b]
    return p


def assert_close(got, want, kp3d, peaks_equal_only=False):
    from betapose_tpu.geometry import metrics
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got["det_valid"], want["det_valid"])
    np.testing.assert_allclose(got["kp_scores"], want["kp_scores"],
                               rtol=1e-4,
                               atol=1e-4 * np.abs(want["kp_scores"]).max())
    near = np.abs(got["keypoints"] - want["keypoints"]).max(axis=(1, 2))
    same = near <= 1e-3
    if not peaks_equal_only:
        assert same.all(), near
        np.testing.assert_array_equal(got["pose_valid"], want["pose_valid"])
    assert same.sum() >= len(same) // 2, near
    for b in np.flatnonzero(same):
        pw, pg = _pose(want, b), _pose(got, b)
        if peaks_equal_only:
            # random networks' keypoints put the poses tens of metres
            # away, where PnP turns 1e-3 px into ~1e-4 of the depth
            assert metrics.add_err(pw, pg, kp3d) < 1e-3 * abs(pw[2, 3])
            assert metrics.rot_error(pw, pg) < 0.1
        else:
            assert metrics.add_err(pw, pg, kp3d) < 1e-4
            assert metrics.rot_error(pw, pg) < 1e-2


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_matches_the_single_process_pipeline(runs, case):
    outs, single, _, _, _, kp3d = runs
    assert set(outs[case]) == set(single[case])
    assert_close(outs[case], single[case], kp3d)


@pytest.mark.parametrize("mp_sp", HG_CASES)
def test_sharded_hgprm_matches_the_single_process_pipeline(runs, mp_sp):
    outs, single, _, _, _, kp3d = runs
    assert_close(outs[("hgprm", *mp_sp)], single["hgprm"], kp3d)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_matches_the_jax_sharded_pipeline(runs, case):
    outs, _, ref, _, _, kp3d = runs
    assert_close(outs[case], ref[case], kp3d, peaks_equal_only=True)


def test_tensor_parallel_holds_half_the_channels_and_host_nms_raises(runs):
    _, _, _, shapes, raised, _ = runs
    assert shapes["dp4"] == (64, 3, 7, 7)
    assert shapes["dp2_tp2"] == (32, 3, 7, 7)
    assert "host" in raised
