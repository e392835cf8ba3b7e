"""The port's self-test (`tools/selftest.py`) against the JAX package's, on
the CPU at the tiny size of tests/test_selftest_smoke.py (reso 96, 64x32
crops, 8 keypoints):

- scenes (`make_scene`, clean, occluded and with keypoint visibility) are
  bitwise equal, and so is the `config.json` fingerprint of every tier;
- a `params_dir` cache crosses between the packages both ways: written by
  the JAX package (its init, YOLO's heads scaled to unit spread so that
  every frame is detected) it grades in the port, and trained by the port
  (2 iterations) it grades in the JAX package, to the same n_detected and
  IoU, with mean and median ADD and 2D error within rtol 1e-3;
- stale cache epochs and mismatched fingerprints are refused;
- the CLI's tiers pass the JAX CLI's arguments to `run_selftest`.

The cross-package evals run PnP with no robust rounds on all keypoints:
on the keypoints of random or barely trained networks the trimmed rounds
rank near-tied residuals, and the packages' float32 orders then drop
different points and land in different minima (measured: poses 1.7 apart
in rotation from keypoints equal to 1e-4 px).  With plain LM the poses
agree to 2e-5 of ADD."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from betapose_tpu.core import checkpoint as jax_ckpt  # noqa: E402
from betapose_tpu.models import kpd as jax_kpd  # noqa: E402
from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu.tools import selftest as jax_st  # noqa: E402
from betapose_tpu_torch.tools import selftest as st  # noqa: E402

TINY = dict(n_frames=6, n_eval=2, yolo_iters=2, kpd_iters=2, reso=96,
            inp_h=64, inp_w=32, n_kp=8, pnp_robust_rounds=0,
            left_keypoints=None, verbose=False)
RTOL = 1e-3


# -------------------------------------------------------------------- scenes

@pytest.mark.parametrize("case", ["clean", "occluded", "kp_vis",
                                  "kp_vis_occluded"])
def test_make_scene_matches_jax(case):
    occ = case.endswith("occluded")
    kw = {}
    if case.startswith("kp_vis"):
        kw["kp3d"] = st.cube_keypoints(st.CubeModel(), 8)
    for seed in range(3):
        ours = st.make_scene(np.random.default_rng(seed), st.CubeModel(),
                             occluder=st.distractor_model() if occ else None,
                             **kw)
        theirs = jax_st.make_scene(
            np.random.default_rng(seed), jax_st.CubeModel(),
            occluder=jax_st.distractor_model() if occ else None, **kw)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_models_and_keypoints_match_jax():
    for ours, theirs in ((st.CubeModel(), jax_st.CubeModel()),
                         (st.distractor_model(), jax_st.distractor_model())):
        for k in ("vertices", "colors", "faces"):
            np.testing.assert_array_equal(getattr(ours, k),
                                          getattr(theirs, k))
    # the JAX run_selftest's inline designation: corners, centers, edges
    h = st.CubeModel().half
    corners = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                        for z in (-h, h)])
    kp = st.cube_keypoints(st.CubeModel(), 26)
    np.testing.assert_array_equal(kp[:8], corners)
    assert kp.shape == (26, 3) and len(np.unique(kp, axis=0)) == 26
    np.testing.assert_array_equal(st.cube_keypoints(st.CubeModel(), 12),
                                  kp[:12])
    assert st.YOLO_CFG == jax_st.YOLO_CFG
    assert st.CACHE_VERSION == jax_st.CACHE_VERSION
    np.testing.assert_array_equal(st.CAM_K, jax_st.CAM_K)


def test_make_scene_keypoint_visibility():
    """make_scene(kp3d=...) reports which keypoints the occluder hides;
    all visible without an occluder."""
    model = st.CubeModel()
    kp3d = st.cube_keypoints(model, 8)
    *_, vis_clean = st.make_scene(np.random.default_rng(5), model, kp3d=kp3d)
    assert vis_clean.shape == (8,) and vis_clean.min() == 1.0
    hidden_any = False
    for seed in range(12):
        *_, vis = st.make_scene(np.random.default_rng(seed), model,
                                occluder=st.distractor_model(), kp3d=kp3d)
        assert set(np.unique(vis)) <= {0.0, 1.0}
        hidden_any = hidden_any or (vis == 0).any()
    assert hidden_any


# ---------------------------------------------------------------- the cache

class _Rendered(Exception):
    pass


def _fingerprint(mod, path, monkeypatch, **kw):
    """The config.json `mod.run_selftest(**kw)` writes before it renders
    (rendering is stopped by a sentinel)."""
    def stop(*a, **k):
        raise _Rendered

    monkeypatch.setattr(mod, "make_scene", stop)
    extra = {"device": "cpu"} if mod is st else {}
    with pytest.raises(_Rendered):
        mod.run_selftest(params_dir=str(path), **kw, **extra)
    with open(path / "config.json") as f:
        return f.read()


@pytest.mark.parametrize("variant", [
    {}, {"train_precision": "float32"}, {"train_precision": "bfloat16"},
    {"train_precision": "tensorfloat32"}, {"net_type": "hgPRM"},
    {"occlusion": True, "add_dpg": True, "kpd_finetune_iters": 3,
     "z_range": (0.45, 0.65)}])
def test_fingerprint_matches_jax(variant, tmp_path, monkeypatch):
    """Same keys, value types and text: `z_range` a list, the default
    precision resolving to bfloat16, `train_precision` left out for
    float32 and `net_type` for resnet50, as the JAX package writes."""
    kw = dict(TINY, **variant)
    ours = _fingerprint(st, tmp_path / "ours", monkeypatch, **kw)
    theirs = _fingerprint(jax_st, tmp_path / "jax", monkeypatch, **kw)
    assert json.loads(ours) == json.loads(theirs)
    assert ours == theirs
    fp = json.loads(ours)
    assert isinstance(fp["z_range"], list)
    assert fp.get("train_precision") == (
        None if variant.get("train_precision") == "float32"
        else variant.get("train_precision", "bfloat16"))


def test_stale_cache_epoch_and_mismatch_refused(tmp_path):
    """A manifest stamped with an older cache epoch (or none) is refused
    before any rendering or training, whatever its other knobs say; a
    knob mismatch at the current epoch is refused too."""
    cache = tmp_path / "cache"
    cache.mkdir()
    kw = dict(n_frames=2, n_eval=1, yolo_iters=1, kpd_iters=1, reso=96,
              inp_h=64, inp_w=32, n_kp=8, params_dir=str(cache),
              verbose=False, device="cpu")
    stale = {"n_frames": 2, "reso": 96, "inp_h": 64, "inp_w": 32,
             "n_kp": 8, "seed": 0, "z_range": [0.55, 0.8],
             "yolo_iters": 1, "kpd_iters": 1, "kpd_finetune_iters": 0,
             "kpd_batch": 8, "add_dpg": False, "occlusion": False,
             "train_precision": "bfloat16"}
    (cache / "config.json").write_text(json.dumps(stale))
    with pytest.raises(ValueError, match="cache epoch 1"):
        st.run_selftest(**kw)
    stale["cache_version"] = st.CACHE_VERSION - 1
    (cache / "config.json").write_text(json.dumps(stale))
    with pytest.raises(ValueError, match="cache epoch"):
        st.run_selftest(**kw)
    good = dict(stale, cache_version=st.CACHE_VERSION, n_frames=999)
    (cache / "config.json").write_text(json.dumps(good))
    with pytest.raises(ValueError, match="different config"):
        st.run_selftest(**kw)
    assert not (cache / "yolo.weights").exists()


def _jax_init_cache(cache, monkeypatch):
    """config.json as the JAX selftest writes it, then yolo.weights and
    kpd.npz from the JAX package's init, YOLO's head conv scaled so its
    raw output has unit spread on rendered scenes (the card smoke's
    calibrate_yolo_heads): every frame is then detected."""
    _fingerprint(jax_st, cache, monkeypatch, **TINY)
    monkeypatch.undo()
    spec = jax_yolo.build_spec(jax_st.YOLO_CFG.format(reso=96))
    yp = jax_yolo.init_params(jax.random.PRNGKey(0), spec)
    frames = np.stack([jax_st.make_scene(np.random.default_rng(s),
                                         jax_st.CubeModel())[0]
                       for s in range(4)])
    x = jnp.asarray(frames[:, ::5, ::5][:, :96, :96], jnp.float32) / 255.0
    heads = jax_yolo.forward(spec, yp, x, 96, decode=False)
    yp = list(yp)
    for i, h in zip(spec.yolo_idxs, heads):
        s = float(jnp.std(h))
        yp[i - 1] = {k: v / s for k, v in yp[i - 1].items()}
    jax_yolo.save_darknet_weights(spec, jax.device_get(yp),
                                  str(cache / "yolo.weights"))
    kp = jax_kpd.init_params(jax.random.PRNGKey(1), n_classes=8,
                             arch="resnet50")
    jax_ckpt.save_pytree_npz(str(cache / "kpd.npz"), jax.device_get(kp))


def _assert_same_grades(ours, theirs):
    assert ours["n_eval"] == theirs["n_eval"] == 2
    assert ours["n_detected"] == theirs["n_detected"]
    assert ours["add_01d_acc"] == theirs["add_01d_acc"]
    assert ours["diameter_m"] == theirs["diameter_m"]
    for k in ("mean_add_m", "median_add_m", "mean_2d_px", "median_2d_px",
              "mean_iou"):
        assert np.isfinite(ours[k]), k
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, err_msg=k)


def test_cache_from_jax_grades_in_port(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    _jax_init_cache(cache, monkeypatch)
    # the .weights file holds exactly the tiny cfg's parameters
    spec = st.yolo_mod.build_spec(st.YOLO_CFG.format(reso=96))
    n_params = sum(p.numel() for p in st.yolo_mod.Darknet(spec, 96)
                   .state_dict().values() if p.dtype == torch.float32)
    assert os.path.getsize(cache / "yolo.weights") == 16 + 4 * n_params
    ours = st.run_selftest(params_dir=str(cache), device="cpu", **TINY)
    theirs = jax_st.run_selftest(params_dir=str(cache), **TINY)
    assert ours["n_detected"] == 2
    _assert_same_grades(ours, theirs)


def test_cache_from_port_grades_in_jax(tmp_path):
    cache = tmp_path / "cache"
    report, seen = {}, []
    ours = st.run_selftest(params_dir=str(cache), device="cpu",
                           report=report, **TINY,
                           eval_hook=lambda p, f: seen.append((p, f)))
    assert {"render_s", "yolo_s", "kpd_s", "eval_s"} <= set(report)
    (pipe, frames), = seen
    assert frames.shape == (TINY["n_eval"], 480, 640, 3)
    assert pipe.cfg.reso == TINY["reso"]
    assert (cache / "yolo.weights").exists() and (cache / "kpd.npz").exists()
    again = st.run_selftest(params_dir=str(cache), device="cpu", **TINY)
    assert again == ours
    theirs = jax_st.run_selftest(params_dir=str(cache), **TINY)
    _assert_same_grades(ours, theirs)


def test_run_selftest_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.run_selftest(**TINY)


# ----------------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv", [
    [], ["--slow"], ["--occlusion"], ["--slow", "--netType", "hgPRM",
                                      "--train_precision", "float32"],
    ["--occlusion", "--det_capacity", "2", "--pnp_robust", "0",
     "--pnp_score_power", "2", "--left_kp", "12"],
    ["--frames", "10", "--yolo_iters", "3", "--kpd_iters", "4",
     "--eval_frames", "2", "--params_dir", "d", "--left_kp", "5",
     "--pnp_robust", "1"]])
def test_cli_tiers_match_jax(argv, monkeypatch):
    """Every flag and tier of the JAX CLI reaches run_selftest with the
    JAX CLI's values; --device is added and defaults to cuda."""
    got = {}

    def capture(name):
        def run(**kw):
            got[name] = kw
            return {}
        return run

    monkeypatch.setattr(st, "run_selftest", capture("ours"))
    monkeypatch.setattr(jax_st, "run_selftest", capture("jax"))
    st.main(argv)
    jax_st.main(argv)
    assert got["ours"].pop("device") == "cuda"
    assert got["ours"] == got["jax"]
    st.main(argv + ["--device", "cpu"])
    assert got["ours"]["device"] == "cpu"
