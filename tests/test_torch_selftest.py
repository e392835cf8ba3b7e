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


# ------------------------------------------- the comparison's precision

def test_jax_bfloat16_conv_on_the_cpu_is_its_float32_conv():
    """Why the packages' CPU comparisons run at float32: under the JAX
    package's default train precision, `jax.default_matmul_precision(
    "bfloat16")`, XLA:CPU computes the float32 conv bit for bit, not the
    conv of bf16-rounded operands, which the port's "bfloat16" mode
    computes on every device (`models/precision.Conv2d`)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, 32)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((3, 3, 32, 64)) * 0.1, jnp.float32)

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    with jax.default_matmul_precision("float32"):
        f32 = np.asarray(jax.jit(conv)(x, w))
    with jax.default_matmul_precision("bfloat16"):
        bf16_mode = np.asarray(jax.jit(conv)(x, w))
    rounded = np.asarray(jax.jit(conv)(x.astype(jnp.bfloat16).astype(
        jnp.float32), w.astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(bf16_mode, f32)
    assert np.abs(rounded - f32).max() > 1e-2

    # the port's "bfloat16" mode is the conv of the rounded operands
    from betapose_tpu_torch.models.precision import Conv2d, conv_precision
    conv_t = Conv2d(32, 64, 3, padding=1, bias=False)
    with torch.no_grad():
        conv_t.weight.copy_(torch.from_numpy(
            np.asarray(w).transpose(3, 2, 0, 1).copy()))
    xt = torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy())
    with conv_precision(conv_t, "bfloat16"), torch.no_grad():
        port_bf16 = conv_t(xt).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(port_bf16, rounded, rtol=0, atol=1e-4)
    assert np.abs(port_bf16 - f32).max() > 1e-2


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_selftest_seeds_passes_the_precision_to_both_packages(precision,
                                                              monkeypatch):
    import subprocess
    import selftest_seeds
    codes = []

    def fake_run(cmd, **kw):
        codes.append(cmd[-1])
        return subprocess.CompletedProcess(
            cmd, 0, stdout='STATS {"mean_add_m": 0.1}\n', stderr="")
    monkeypatch.setattr(selftest_seeds.subprocess, "run", fake_run)
    rows = [selftest_seeds.run_one(pkg, 0, 1, precision,
                                   torch_device="cuda")
            for pkg in ("jax", "torch")]
    for code in codes:
        assert f"train_precision={precision!r}" in code
    assert "betapose_tpu.tools.selftest" in codes[0]
    assert "'device': 'cuda'" in codes[1]
    assert [r["train_precision"] for r in rows] == [precision] * 2
    assert [r["device"] for r in rows] == ["cpu", "cuda"]
    seen = []
    monkeypatch.setattr(selftest_seeds, "run_one",
                        lambda pkg, s, th, p, *rest: seen.append((pkg, s, p))
                        or {"package": pkg, "seed": s, "wall_s": 0,
                            "stats": {"mean_add_m": 0.1, "add_01d_acc": 0,
                                      "median_add_m": 0.1, "mean_2d_px": 1,
                                      "n_detected": 1, "mean_iou": 0.5}})
    selftest_seeds.main(["--seeds", "0,1", "--jobs", "1",
                         "--train_precision", precision])
    assert sorted(seen) == [("jax", 0, precision), ("jax", 1, precision),
                            ("torch", 0, precision), ("torch", 1, precision)]


def test_selftest_starts_from_a_given_init_and_replays_draws(tmp_path):
    """`run_selftest(yolo_init=, yolo_draws=)`, the hooks through which
    selftest_seeds.py --swap hands the JAX package's detector init and
    loop draws to the port: a .weights init is where training starts
    (0 iterations save it unchanged), and replaying the draws the loop's
    own generator would make trains the same detector as the generator."""
    from betapose_tpu_torch.models import yolov3 as port_yolo
    from betapose_tpu_torch.train import yolo_train as port_train
    spec = port_yolo.build_spec(st.YOLO_CFG.format(reso=96))
    init = port_yolo.Darknet(spec, 96, torch.Generator().manual_seed(5))
    init_path = str(tmp_path / "init.weights")
    port_yolo.save_darknet_weights(init, init_path)
    kw = dict(TINY, kpd_iters=0, device="cpu")

    def trained(name, **extra):
        d = tmp_path / name
        st.run_selftest(params_dir=str(d), **{**kw, **extra})
        m, _ = port_yolo.load_darknet_weights(spec, str(d / "yolo.weights"),
                                              96)
        return port_yolo.params_to_jax(m)

    got = trained("zero", yolo_init=init_path, yolo_iters=0)
    for a, b in zip(got, port_yolo.params_to_jax(init)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    gen = torch.Generator().manual_seed(3)
    ycfg = port_train.YoloTrainConfig()
    rows = [port_train.draw_random(16, 480, 640, ycfg, gen)
            for _ in range(2)]
    draws = str(tmp_path / "draws.npz")
    np.savez(draws, **{k: np.stack([r[k].numpy() for r in rows])
                       for k in port_train.DRAWS})
    own, replayed = trained("own"), trained("replayed", yolo_draws=draws)
    for a, b in zip(own, replayed):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.savez(draws, **{k: np.stack([r[k].numpy()[::-1] for r in rows])
                       for k in port_train.DRAWS})
    other = trained("other", yolo_draws=draws)
    assert any(not np.array_equal(a[k], b[k])
               for a, b in zip(own, other) for k in a)

    # the KPD loop's hooks: an .npz init, and its generator's draws
    from betapose_tpu_torch.core import checkpoint as port_ckpt
    from betapose_tpu_torch.models import kpd as port_kpd
    from betapose_tpu_torch.train import augment as port_aug
    kinit = port_kpd.FastPose(8, "resnet50", torch.Generator().manual_seed(7))
    kinit_path = str(tmp_path / "kinit.npz")
    port_ckpt.save_kpd_npz(kinit_path, kinit)

    def kpd_sd(name, **extra):
        d = tmp_path / name
        st.run_selftest(params_dir=str(d), **{**kw, "yolo_iters": 0,
                                              **extra})
        return port_ckpt.load_kpd_checkpoint(str(d / "kpd.npz"), 8,
                                             "resnet50").state_dict()

    for k, v in kpd_sd("k0", kpd_init=kinit_path).items():
        assert torch.equal(v, kinit.state_dict()[k]), k
    kgen = torch.Generator().manual_seed(2)
    acfg = port_aug.AugmentConfig()
    krows = [port_aug.draw_random(8, acfg, kgen) for _ in range(2)]
    kdraws = str(tmp_path / "kdraws.npz")
    np.savez(kdraws, **{k: np.stack([r[k].numpy() for r in krows])
                        for k in port_aug.DRAWS})
    own_k = kpd_sd("kown", kpd_iters=2)
    rep_k = kpd_sd("krep", kpd_iters=2, kpd_draws=kdraws)
    for k, v in own_k.items():
        assert torch.equal(v, rep_k[k]), k


def test_selftest_seeds_swap_writes_the_jax_loops_init_and_draws(tmp_path):
    """selftest_seeds.py --swap: the .weights file is the JAX package's
    seeded detector init, and the draws are those its fast-tier loop makes
    (PRNGKey(3) split once per iteration, then per sample)."""
    import selftest_seeds
    from betapose_tpu.train import yolo_train as jax_train
    from betapose_tpu_torch.models import yolov3 as port_yolo
    from tests.test_torch_yolo_train import jax_aug_draws
    paths = selftest_seeds.write_swap(str(tmp_path), 3, 2)
    init, draws = paths["init"], paths["draws"]
    spec = jax_yolo.build_spec(jax_st.YOLO_CFG.format(reso=192))
    ref = jax_yolo.init_params(jax.random.PRNGKey(0), spec)
    got = port_yolo.params_to_jax(port_yolo.load_darknet_weights(
        port_yolo.build_spec(st.YOLO_CFG.format(reso=192)), init, 192)[0])
    for a, b in zip(got, ref):
        for k in b:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    key = jax.random.PRNGKey(3)
    with np.load(draws) as z:
        assert z["pleft"].shape == (3, 16)
        for it in range(2):
            key, k1 = jax.random.split(key)
            want = jax_aug_draws(k1, 16, 480, 640,
                                 jax_train.YoloTrainConfig())
            for k, v in want.items():
                np.testing.assert_array_equal(z[k][it], v.numpy(), err_msg=k)
    # the KPD loop's: the JAX init, and PRNGKey(2)'s per-iteration splits
    from betapose_tpu.train import augment as jax_aug
    from tests.test_torch_augment import jax_draws
    kref = jax_kpd.init_params(jax.random.PRNGKey(1), n_classes=12,
                               arch="resnet50")
    kgot = jax_ckpt.load_pytree_npz(paths["kpd_init"], kref)
    for a, b in zip(jax.tree_util.tree_leaves(kgot),
                    jax.tree_util.tree_leaves(kref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax_aug.AugmentConfig().scale_min == 0.2   # jax_draws' CFG's
    key = jax.random.PRNGKey(2)
    with np.load(paths["kpd_draws"]) as z:
        assert z["rate"].shape == (2, 8) and z["gauss"].shape == (2, 8, 4)
        for it in range(2):
            key, k1 = jax.random.split(key)
            for j, k in enumerate(jax.random.split(k1, 8)):
                for name, v in jax_draws(k).items():
                    np.testing.assert_array_equal(z[name][it, j],
                                                  np.asarray(v))
    stamp = os.path.getmtime(draws)
    assert selftest_seeds.write_swap(str(tmp_path), 2, 1) == paths
    assert os.path.getmtime(draws) == stamp          # reused, not rewritten
