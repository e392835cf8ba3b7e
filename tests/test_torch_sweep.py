"""The port's multi-object tiers (`tools/objects.py`, `tools/sweep.py`,
`tools/occl_multiobj.py`) against the JAX package's, on the CPU:

- the 13-object zoo (meshes, keypoints, symmetry groups and keypoint
  permutations), `canonicalize_pose`, `render_sequence` and
  `make_multi_scene` are bitwise equal (numpy copies, tolerance 0), and so
  are the SIXD tree and the `config.json` fingerprints both tiers write;
- `evaluate_object` grades the same fake pipeline output to the same row
  (ADD-S passing a symmetric object's flipped mode that plain ADD fails);
- `--out_json` is written atomically and ends with "partial": false;
  both mains refuse to start while the card is claimed;
- a cut sweep and the occlusion tier run end to end at toy size (marked
  slow, as the JAX package marks its own)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("cv2")

from betapose_tpu.tools import objects as jax_objects  # noqa: E402
from betapose_tpu.tools import occl_multiobj as jax_occl  # noqa: E402
from betapose_tpu.tools import sweep as jax_sweep  # noqa: E402
from betapose_tpu_torch.core import watchdog as wd_mod  # noqa: E402
from betapose_tpu_torch.tools import objects  # noqa: E402
from betapose_tpu_torch.tools import occl_multiobj as occl  # noqa: E402
from betapose_tpu_torch.tools import sweep  # noqa: E402

NAMES = tuple(objects.OBJECT_BUILDERS)


def _rand_rot(rng):
    q = rng.standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


# ---------------------------------------------------------------- the zoo

@pytest.mark.parametrize("name", NAMES)
def test_object_matches_jax(name):
    assert tuple(jax_objects.OBJECT_BUILDERS) == NAMES
    for n_kp in (8, 26):
        ours = objects.OBJECT_BUILDERS[name](n_kp)
        theirs = jax_objects.OBJECT_BUILDERS[name](n_kp)
        for k in ("vertices", "colors", "faces", "keypoints"):
            np.testing.assert_array_equal(getattr(ours, k),
                                          getattr(theirs, k))
        assert ours.diameter == theirs.diameter and ours.name == name
        assert len(ours.symmetries) == len(theirs.symmetries)
        for a, b in zip(ours.symmetries, theirs.symmetries):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.symmetry_perms, theirs.symmetry_perms):
            np.testing.assert_array_equal(a, b)
    # the JAX zoo tests' invariants, on the port's copy
    o = objects.OBJECT_BUILDERS[name](26)
    assert o.keypoints.shape == (26, 3) and 0.05 < o.diameter < 0.2
    assert not any(o.contains_interior(k) for k in o.keypoints)
    for S, perm in zip(o.symmetries, o.symmetry_perms):
        np.testing.assert_allclose(o.keypoints @ S.T, o.keypoints[perm],
                                   atol=1e-9)


@pytest.mark.parametrize("name", ["prism", "quad", "slab", "cube"])
def test_canonicalize_pose_matches_jax(name):
    o = objects.OBJECT_BUILDERS[name]()
    rng = np.random.default_rng(0)
    for _ in range(40):
        pose = np.eye(4)
        pose[:3, :3] = _rand_rot(rng)
        pose[:3, 3] = rng.uniform(-1, 1, 3)
        c = objects.canonicalize_pose(pose, o.symmetries)
        np.testing.assert_array_equal(
            c, jax_objects.canonicalize_pose(pose, o.symmetries))
        # the orbit collapses: every mode canonicalizes to one pose
        for S in o.symmetries:
            p2 = pose.copy()
            p2[:3, :3] = pose[:3, :3] @ S
            np.testing.assert_allclose(
                objects.canonicalize_pose(p2, o.symmetries), c, atol=1e-12)


def test_symmetry_perms_match_jax():
    for n_kp in (8, 12, 20, 26):
        p = objects.prism_object(n_kp)
        q = jax_objects.prism_object(n_kp)
        for a, b in zip(p.symmetry_perms, q.symmetry_perms):
            np.testing.assert_array_equal(a, b)
        (perm,) = p.symmetry_perms
        np.testing.assert_array_equal(perm[perm], np.arange(n_kp))
    with pytest.raises(ValueError):
        objects.symmetry_keypoint_perms(
            np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
            (np.diag([-1.0, -1.0, 1.0]),))


# ------------------------------------------------------------------ scenes

@pytest.mark.parametrize("name", ["prism", "checker"])
def test_render_sequence_matches_jax(name):
    o = objects.OBJECT_BUILDERS[name](8)
    ours = sweep.render_sequence(np.random.default_rng([0, 101]), o, 2,
                                 (0.45, 0.65))
    theirs = jax_sweep.render_sequence(np.random.default_rng([0, 101]),
                                       jax_objects.OBJECT_BUILDERS[name](8),
                                       2, (0.45, 0.65))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def _models(mod):
    return [mod.cube_object(8), mod.lwedge_object(8)]


@pytest.mark.parametrize("seed", [0, 3])
def test_make_multi_scene_matches_jax(seed):
    """Clean targets, mutual occlusion and the distractor (seed 0 and 3
    place it), bitwise."""
    from betapose_tpu.tools.selftest import distractor_model as jax_distr
    from betapose_tpu_torch.tools.selftest import distractor_model
    ours = occl.make_multi_scene(np.random.default_rng(seed),
                                 _models(objects), distractor_model())
    theirs = jax_occl.make_multi_scene(np.random.default_rng(seed),
                                       _models(jax_objects), jax_distr())
    np.testing.assert_array_equal(ours[0], theirs[0])
    for (p1, b1, o1), (p2, b2, o2) in zip(ours[1], theirs[1]):
        np.testing.assert_array_equal(p1, p2)
        assert b1 == b2 and o1 == o2
        assert b1[2] > b1[0] and b1[3] > b1[1] and 0.0 <= o1 < 1.0


def test_write_sixd_tree_matches_jax(tmp_path):
    from betapose_tpu_torch.data import sixd as sixd_mod
    from betapose_tpu_torch.tools.selftest import distractor_model
    objs = dict(zip((1, 2), _models(objects)))
    rng = np.random.default_rng(1)
    frames, gt = [], []
    for _ in range(2):
        frame, per = occl.make_multi_scene(rng, list(objs.values()),
                                           distractor_model())
        frames.append(frame)
        gt.append({oid: per[i] for i, oid in enumerate(objs)})
    occl.write_sixd_tree(str(tmp_path / "ours"), objs, frames, gt)
    jax_occl.write_sixd_tree(str(tmp_path / "jax"), objs, frames, gt)
    for root, _, files in os.walk(tmp_path / "ours"):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), tmp_path / "ours")
            with open(os.path.join(root, f), "rb") as a, \
                    open(tmp_path / "jax" / rel, "rb") as b:
                assert a.read() == b.read(), rel
    bench = sixd_mod.load_sixd(str(tmp_path / "ours"),
                               seq=occl.OCCLUSION_SEQ, nr_frames=0)
    assert [sorted(e[0] for e in fr.gt) for fr in bench.frames] == [[1, 2]] * 2


# -------------------------------------------------------------- the caches

class _Rendered(Exception):
    pass


def _fingerprint(mod, name, path, monkeypatch, **kw):
    def stop(*a, **k):
        raise _Rendered

    monkeypatch.setattr(mod, name, stop)
    extra = {"device": "cpu"} if mod in (sweep, occl) else {}
    run = mod.run_sweep if mod in (sweep, jax_sweep) else mod.run_occl_multiobj
    with pytest.raises(_Rendered):
        run(params_dir=str(path), verbose=False, **kw, **extra)
    with open(path / "config.json") as f:
        return f.read()


@pytest.mark.parametrize("tier,variant", [
    ("sweep", {}), ("sweep", {"train_precision": "float32"}),
    ("sweep", {"yolo_frames": 4, "object_names": ("cube", "prism")}),
    ("occl", {}), ("occl", {"train_precision": "tensorfloat32"})])
def test_fingerprint_matches_jax(tier, variant, tmp_path, monkeypatch):
    kw = dict(n_frames=6, n_kp=8, **variant)
    if tier == "sweep":
        pair, name = (sweep, jax_sweep), "make_scene"
    else:
        pair, name = (occl, jax_occl), "make_multi_scene"
    ours = _fingerprint(pair[0], name, tmp_path / "o", monkeypatch, **kw)
    theirs = _fingerprint(pair[1], name, tmp_path / "j", monkeypatch, **kw)
    assert json.loads(ours) == json.loads(theirs) and ours == theirs
    # a changed knob is refused
    monkeypatch.undo()
    with pytest.raises(ValueError, match="different config"):
        _fingerprint(pair[0], name, tmp_path / "o", monkeypatch,
                     **dict(kw, n_frames=7))


# ------------------------------------------------------------- evaluation

class _FakePipe:
    """Stands in for PosePipeline: fixed per-frame outputs."""

    def __init__(self, out, as_tensors):
        self.out = ({k: torch.as_tensor(v) for k, v in out.items()}
                    if as_tensors else out)

    def __call__(self, frames):
        return self.out


def test_evaluate_object_adds_on_a_symmetric_object():
    """The prism predicted in its flipped mode: plain ADD fails, ADD-S and
    the symmetry-aware 2D column pass; an undetected frame and a box with
    IoU < 0.5 count against both.  The row equals the JAX package's."""
    o = objects.prism_object(8)
    (S,) = o.symmetries
    rng = np.random.default_rng(2)
    poses, boxes = [], []
    for _ in range(4):
        p = np.eye(4)
        p[:3, :3] = _rand_rot(rng)
        p[:3, 3] = [0.01, -0.02, 0.55]
        poses.append(p)
        boxes.append([250.0, 180.0, 390.0, 300.0])
    poses, boxes = np.stack(poses), np.asarray(boxes, np.float32)
    pred_R = np.stack([p[:3, :3] @ S for p in poses])
    out = {"det_valid": np.array([True, True, False, True]),
           "cam_R": pred_R.astype(np.float32),
           "cam_t": poses[:, :3, 3].astype(np.float32),
           "boxes": np.array([boxes[0], boxes[1], boxes[2],
                              [0.0, 0.0, 40.0, 40.0]], np.float32)}
    frames = np.zeros((4, 480, 640, 3), np.uint8)
    row = sweep.evaluate_object(_FakePipe(out, True), frames, poses, boxes,
                                o)
    jrow = jax_sweep.evaluate_object(_FakePipe(out, False), frames, poses,
                                     boxes, jax_objects.prism_object(8))
    assert row == jrow
    assert row["symmetric"] and row["n_detected"] == 3
    assert row["add_acc"] == 0.0 and row["adds_acc"] == 0.5
    assert row["mean_adds_m"] < 1e-6 < row["mean_add_m"]
    assert row["mean_2d_px_sym"] < 1e-3 < row["mean_2d_px"]


def test_json_sanitize_and_atomic_write(tmp_path):
    """Strict JSON (inf/nan become null, tuples lists), written through a
    .tmp file that os.replace swaps in: no .tmp is left, and a failed
    dump leaves the previous file whole."""
    out = sweep.json_sanitize({"rows": [{"mean_add_m": float("inf"),
                                         "acc": 0.5,
                                         "nested": (float("nan"), 1)}]})
    assert out == jax_sweep.json_sanitize(
        {"rows": [{"mean_add_m": float("inf"), "acc": 0.5,
                   "nested": (float("nan"), 1)}]})
    s = json.dumps(out)
    assert "Infinity" not in s and "NaN" not in s
    path = str(tmp_path / "t.json")
    sweep.write_json_atomic(path, {"a": float("inf"), "partial": False})
    assert json.load(open(path)) == {"a": None, "partial": False}
    assert os.listdir(tmp_path) == ["t.json"]
    with pytest.raises(TypeError):
        sweep.write_json_atomic(path, {"a": object()})
    assert json.load(open(path)) == {"a": None, "partial": False}


@pytest.mark.parametrize("mod", [sweep, occl])
def test_main_refuses_a_claimed_card(mod, tmp_path, monkeypatch):
    """main checks the claim before anything touches the device (exit
    code 4, the watchdog's yield code), and starts once it clears."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    started = []
    runner = "run_sweep" if mod is sweep else "run_occl_multiobj"
    monkeypatch.setattr(mod, runner, lambda **kw: started.append(kw) or {})
    wd_mod.claim_chip("bench")
    with pytest.raises(SystemExit) as e:
        mod.main(["--stall_timeout", "0"])
    assert e.value.code == 4 and started == []
    wd_mod.release_chip()
    mod.main(["--stall_timeout", "0", "--device", "cpu"])
    assert started[0]["device"] == "cpu"


def test_occl_main_writes_partial_false(tmp_path, monkeypatch):
    monkeypatch.setattr(occl, "run_occl_multiobj",
                        lambda **kw: {1: {"mean_add": 0.5,
                                          "mean_add_err": float("nan")}})
    path = str(tmp_path / "o.json")
    occl.main(["--stall_timeout", "0", "--out_json", path])
    assert json.load(open(path)) == {"1": {"mean_add": 0.5,
                                           "mean_add_err": None},
                                     "partial": False}


def test_occl_run_removes_its_temp_dirs_and_hands_over_the_cli_pipeline(
        tmp_path, monkeypatch):
    """Without params_dir / work_dir the weights and the SIXD tree live in
    temporary directories that are gone on return; eval_hook gets each
    run of the occlusion CLI's pipeline with the held-out frames."""
    import tempfile

    from betapose_tpu_torch.eval import occlusion_betapose_evaluate as cli
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def touch(path):
        open(path, "w").close()

    monkeypatch.setattr(occl, "train_detector", lambda *a, **k: None)
    monkeypatch.setattr(occl, "train_kpd", lambda *a, **k: None)
    monkeypatch.setattr(occl.yolo_mod, "save_darknet_weights",
                        lambda model, path: touch(path))
    monkeypatch.setattr(occl.ckpt, "save_kpd_npz",
                        lambda path, model: touch(path))

    def fake_cli(argv, eval_hook=None):
        flags = dict(zip(argv[::2], argv[1::2]))
        for k in ("--yolo_weights", "--kpd_weights", "--indir"):
            assert os.path.exists(flags[k]), k
        eval_hook(f"pipe{flags['--obj_id']}")
        return {"mean_add": 0.0}

    monkeypatch.setattr(cli, "main", fake_cli)
    seen = []
    out = occl.run_occl_multiobj(
        n_frames=2, n_eval=1, device="cpu", verbose=False,
        eval_hook=lambda pipe, frames: seen.append((pipe, frames.shape)))
    assert sorted(out) == [1, 2]
    assert seen == [("pipe1", (1, 480, 640, 3)), ("pipe2", (1, 480, 640, 3))]
    assert os.listdir(tmp_path) == []


def test_parse_pnp_grid_matches_jax():
    spec = "default;pnp_spread_power=1;pnp_depth_prior=0.3,left_keypoints=20"
    assert occl.parse_pnp_grid(spec) == jax_occl.parse_pnp_grid(spec) == [
        {}, {"pnp_spread_power": "1"},
        {"pnp_depth_prior": "0.3", "left_keypoints": "20"}]


def test_sweep_out_json_rows_then_partial_false(tmp_path):
    """One object at toy size: each row is written with "partial" true
    until the last, the final file carries the summary and "partial":
    false, and a rerun reloads the cache to the same row."""
    out_json = tmp_path / "sweep.json"
    snaps = []

    def snoop():
        if out_json.exists():
            snaps.append(json.loads(out_json.read_text()))

    kw = dict(object_names=("prism", "cube"), n_frames=2, n_eval=1,
              yolo_iters=1, kpd_iters=1, kpd_finetune_iters=0, kpd_batch=2,
              yolo_batch=2, reso=64, inp_h=64, inp_w=32, n_kp=8,
              num_classes=2, left_keypoints=6,
              params_dir=str(tmp_path / "cache"), verbose=False,
              out_json=str(out_json), beat=snoop, device="cpu")
    out = sweep.run_sweep(**kw)
    rows = [s for s in snaps if s.get("per_object")]
    assert [len(s["per_object"]) for s in rows][-2:] == [1, 2]
    assert [s["partial"] for s in rows][-2:] == [True, False]
    final = json.loads(out_json.read_text())
    assert final["partial"] is False
    assert final["all_pass_085"] == out["all_pass_085"]
    assert [r["object"] for r in out["per_object"]] == ["prism", "cube"]
    assert [r["symmetric"] for r in out["per_object"]] == [True, False]
    for name in ("prism", "cube"):
        assert (tmp_path / "cache" / f"kpd_{name}.npz").exists()
    again = sweep.run_sweep(**dict(kw, beat=None))
    assert json.loads(json.dumps(sweep.json_sanitize(again))) == \
        json.loads(json.dumps(sweep.json_sanitize(out)))


# ---------------------------------------------------- the tiers end to end

@pytest.mark.slow
def test_sweep_tiny_smoke(tmp_path):
    """Three objects, a shared 3-class detector, per-object KPD and
    weight caches, as the JAX package's smoke."""
    kw = dict(object_names=("cube", "prism", "lwedge"), n_frames=6,
              n_eval=2, yolo_iters=2, kpd_iters=2, kpd_finetune_iters=0,
              kpd_batch=4, yolo_batch=4, reso=96, inp_h=64, inp_w=32,
              n_kp=8, num_classes=3, left_keypoints=6, yolo_frames=4,
              params_dir=str(tmp_path / "cache"), verbose=False,
              out_json=str(tmp_path / "s.json"), device="cpu")
    out = sweep.run_sweep(**kw)
    rows = out["per_object"]
    assert [r["object"] for r in rows] == ["cube", "prism", "lwedge"]
    assert all(r["n_eval"] == 2 for r in rows)
    assert (tmp_path / "cache" / "yolo.weights").exists()
    out2 = sweep.run_sweep(**kw)
    assert [r["object"] for r in out2["per_object"]] == \
        [r["object"] for r in rows]


@pytest.mark.slow
def test_occl_multiobj_tiny_smoke(tmp_path):
    """Per-object single-class detectors + KPD on cluttered frames, the
    SIXD tree, the port's occlusion CLI per object, then a PnP grid on the
    cached weights."""
    kw = dict(n_frames=6, n_eval=2, yolo_iters=2, kpd_iters=2,
              kpd_finetune_iters=0, kpd_batch=4, yolo_batch=4, reso=96,
              inp_h=64, inp_w=32, n_kp=8,
              params_dir=str(tmp_path / "cache"),
              work_dir=str(tmp_path / "tree"), verbose=False, device="cpu")
    results = occl.run_occl_multiobj(**kw)
    assert sorted(results) == [1, 2]
    for stats in results.values():
        assert {"mean_add", "mean_2d_acc", "mean_iou", "fps"} <= set(stats)
    for oid in (1, 2):
        assert (tmp_path / "cache" / f"yolo_{oid:02d}.weights").exists()
        assert (tmp_path / "cache" / f"kpd_{oid:02d}.npz").exists()
    res = occl.run_occl_multiobj(**kw, pnp_grid=occl.parse_pnp_grid(
        "default;pnp_spread_power=1,pnp_depth_prior=0.3"))
    assert sorted(res) == ["default", "spread_power=1,depth_prior=0.3"]
