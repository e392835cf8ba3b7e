"""The port's offline stages against the JAX package, on the CPU:
quaternions, the geometry helpers, the renderer (colour and depth bitwise
equal; `render_depth_points` as a torch scatter-min equal to the JAX
package's jitted one, off-image and behind-camera points included), the
3D-SIFT designator (numpy twin and native binary), the annotator CLI
(`annot_{train,eval}.h5` array-equal on a synthetic SIXD tree) and the
stall watchdog.  Copied numpy code is held bitwise equal (tolerance 0);
the depth map too, since both packages splat in float32."""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from betapose_tpu.geometry import quaternion as jax_quat  # noqa: E402
from betapose_tpu.geometry import renderer as jax_render  # noqa: E402
from betapose_tpu.geometry import utils as jax_gu  # noqa: E402
from betapose_tpu.tools import annotator as jax_annot  # noqa: E402
from betapose_tpu.tools.designator import designator as jax_dsg  # noqa: E402
from betapose_tpu_torch.core import watchdog as wd_mod  # noqa: E402
from betapose_tpu_torch.data import ply as plyio  # noqa: E402
from betapose_tpu_torch.geometry import quaternion as quat  # noqa: E402
from betapose_tpu_torch.geometry import renderer as render  # noqa: E402
from betapose_tpu_torch.geometry import utils as gu  # noqa: E402
from betapose_tpu_torch.tools import annotator  # noqa: E402
from betapose_tpu_torch.tools.designator import designator as dsg  # noqa: E402
from tests._synth import make_synthetic_sixd  # noqa: E402

CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]])


def _rotations(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out.append(q)
    return out


# ---------------------------------------------------------------- quaternion

def _quat_outputs(mod):
    Q = mod.Quaternion
    out = []
    rots = _rotations(0)
    for a, b in zip(rots, rots[1:]):
        qa, qb = Q(matrix=a), Q(matrix=b)
        out += [qa.q, qa.rotation_matrix, (qa * qb).q, qa.inverse.q,
                qa.conjugate.q, qa.normalised.q, qa.axis, [qa.degrees],
                [qa.radians], [qa.norm], qa.rotate([0.3, -0.2, 0.9]),
                Q.slerp(qa, qb, 0.3).q]
    ax = Q(axis=[0, 0, 1], angle=np.deg2rad(30))
    out += [ax.q, [ax.degrees], Q([1.0, 2.0, 3.0, 4.0]).q,
            Q(0.5, 0.5, 0.5, 0.5).rotation_matrix]
    return out


def test_quaternion_matches_jax():
    for a, b in zip(_quat_outputs(quat), _quat_outputs(jax_quat)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["roundtrip", "multiply", "angle",
                                  "rotate", "slerp"])
def test_quaternion_cases(case):
    """The JAX package's quaternion tests, on the port's copy."""
    Q = quat.Quaternion
    if case == "roundtrip":
        for r in _rotations(1):
            np.testing.assert_allclose(Q(matrix=r).rotation_matrix, r,
                                       atol=1e-10)
    elif case == "multiply":
        a, b = _rotations(2, 2)
        np.testing.assert_allclose((Q(matrix=a) * Q(matrix=b))
                                   .rotation_matrix, a @ b, atol=1e-10)
    elif case == "angle":
        q = Q(axis=[0, 0, 1], angle=np.deg2rad(30))
        assert q.degrees == pytest.approx(30.0, abs=1e-9)
        assert (q * q.inverse).degrees == pytest.approx(0.0, abs=1e-6)
    elif case == "rotate":
        q = Q(axis=[0, 0, 1], angle=np.pi / 2)
        np.testing.assert_allclose(q.rotate([1, 0, 0]), [0, 1, 0],
                                   atol=1e-12)
    else:
        a = Q(axis=[0, 0, 1], angle=0.0)
        b = Q(axis=[0, 0, 1], angle=np.pi / 2)
        np.testing.assert_allclose(Q.slerp(a, b, 0.0).q, a.q, atol=1e-9)
        assert Q.slerp(a, b, 0.5).degrees == pytest.approx(45.0, abs=1e-6)


# ------------------------------------------------------------ geometry utils

def _utils_outputs(mod, tmp_path):
    pose = np.eye(4)
    pose[:3, :3] = _rotations(3, 1)[0]
    pose[:3, 3] = [1, 2, 3]
    mask = np.zeros((10, 12))
    mask[3:6, 4:9] = 1
    kd, kl, ad = np.zeros((3, 4, 4, 3))
    kd[1, 1], kl[1, 1], ad[1, 1] = [5, 0, 0], [3, 3, 3], [1, 0, 0]
    depth = np.zeros((20, 20))
    depth[5:15, 5:15] = 100.0
    depth[7, 7] = 60.0
    ply = str(tmp_path / f"{mod.__name__}.ply")
    mod.output_pointcloud(np.arange(15.0).reshape(5, 3), ply)
    return [mod.trans_vertices_by_pose([[0, 0, 0], [1, 1, 1]], pose),
            mod.get_bbox_from_mask(mask),
            mod.get_bbox_from_mask(np.zeros((4, 4))),
            mod.get_bbox_from_mask(np.stack([mask] * 3, -1)),
            mod.jitter_bbox([10, 10, 50, 60], 0.1,
                            np.random.default_rng(0)),
            *mod.handle_occlusion(kd, kl, ad),
            mod.local_top_visibility(np.array([[10, 10], [2, 2], [7, 7],
                                               [30, 3]]),
                                     np.array([100.0, 100.0, 90.0, 1.0]),
                                     depth, radius=2, threshold=15),
            mod.generate_mask_img(depth),
            mod.generate_mask_img(depth, if_all_black=False),
            plyio.read_vertices(ply)]


def test_geometry_utils_match_jax(tmp_path):
    for a, b in zip(_utils_outputs(gu, tmp_path),
                    _utils_outputs(jax_gu, tmp_path)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["bbox", "occlusion", "visibility"])
def test_geometry_utils_cases(case):
    """The JAX package's geometry-utils tests, on the port's copy."""
    if case == "bbox":
        mask = np.zeros((10, 12))
        mask[3:6, 4:9] = 1
        assert gu.get_bbox_from_mask(mask) == (4, 8, 3, 5)
        assert gu.get_bbox_from_mask(np.zeros((4, 4))) == (-1, -1, -1, -1)
    elif case == "occlusion":
        kd, kl, ad = np.zeros((3, 4, 4, 3))
        kd[1, 1], kl[1, 1], ad[1, 1] = [5, 0, 0], [3, 3, 3], [1, 0, 0]
        kd2, kl2 = gu.handle_occlusion(kd, kl, ad)
        assert kd2[1, 1, 0] == 0 and kl2[1, 1, 0] == 69
    else:
        depth = np.zeros((20, 20))
        depth[5:15, 5:15] = 100.0
        vis = gu.local_top_visibility(np.array([[10, 10], [2, 2]]),
                                      np.array([100.0, 100.0]), depth,
                                      radius=2, threshold=15)
        assert vis[0] and vis[1]
        assert not gu.local_top_visibility(np.array([[10, 10]]),
                                           np.array([200.0]), depth,
                                           radius=2, threshold=15)[0]


# ------------------------------------------------------------------ renderer

class _Mesh:
    pass


def _scene_models():
    """A coloured triangle pair, a textured quad and a point cloud."""
    tri = _Mesh()
    tri.vertices = np.array([[-0.05, -0.05, 0.0], [0.05, -0.05, 0.0],
                             [0.0, 0.05, 0.0], [0.04, 0.06, 0.02]])
    tri.faces = np.array([[0, 1, 2], [1, 3, 2]])
    tri.colors = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
                           [0.5, 0.5, 0]])
    quad = _Mesh()
    quad.vertices = np.array([[-0.05, -0.05, 0.0], [0.05, -0.05, 0.0],
                              [0.05, 0.05, 0.0], [-0.05, 0.05, 0.0]])
    quad.faces = np.array([[0, 1, 2], [0, 2, 3]])
    quad.colors = np.full((4, 3), 0.5)
    quad.texcoord = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    quad.texture = np.random.default_rng(4).random((8, 8, 3))
    cloud = _Mesh()
    cloud.vertices = np.random.default_rng(5).uniform(-0.05, 0.05, (300, 3))
    return tri, quad, cloud


def _render(mod):
    out = []
    for pi, m in enumerate(_scene_models()):
        pose = np.eye(4)
        pose[:3, :3] = _rotations(6 + pi, 1)[0] if pi != 1 else np.eye(3)
        pose[:3, 3] = [0.01 * pi, -0.02, 0.6 + 0.1 * pi]
        r = mod.Renderer(size=(640, 480), cam=CAM_K)
        r.draw_model(m, pose)
        r.draw_boundingbox(m, pose, color=(0, 1, 0))
        out += list(r.finish())
    out.append(mod.build_projection(CAM_K, 0, 0, 640, 480, 0.1, 10.0))
    out.append(mod.build_projection(CAM_K, 2, 3, 640, 480, 0.1, 10.0,
                                    window_coords="y_up"))
    return out


def test_renderer_matches_jax_bitwise():
    """Colour and depth of the rasterizer (flat, textured, point splat and
    wireframe) and the GL projection: bitwise equal."""
    ours, theirs = _render(render), _render(jax_render)
    assert (ours[1] > 0).sum() > 500
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def _splat_points():
    """Seeded points in front of the camera, off-image (left, right,
    above, below, on the x = 0 / y = 0 edges the JAX test excludes),
    behind the camera, at z = 0, and duplicates landing on one pixel."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.06, 0.06, (600, 3))
    pts[:, 2] += 0.7
    off = np.array([[-2.0, 0.0, 0.5], [2.0, 0.0, 0.5], [0.0, -2.0, 0.5],
                    [0.0, 2.0, 0.5], [0.01, 0.01, -0.5], [0.02, 0.0, 0.0],
                    [-0.5682, 0.0, 1.0], [0.0, -0.4219, 1.0],
                    [0.1, 0.1, 0.8], [0.1, 0.1, 0.6], [0.1, 0.1, 0.7]])
    return np.concatenate([pts, off])


def test_render_depth_points_matches_jax():
    pts = _splat_points()
    ours = render.render_depth_points(pts, CAM_K, device="cpu")
    theirs = np.asarray(jax_render.render_depth_points(jnp.asarray(pts),
                                                       jnp.asarray(CAM_K)))
    assert ours.dtype == torch.float32 and ours.shape == (480, 640)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    occupied = ours.numpy() > 0
    assert 100 < occupied.sum() < 611
    # the three points on one pixel keep the nearest
    x = int(np.floor(np.float32(0.1) * np.float32(CAM_K[0, 0])
                     / np.float32(0.6) + np.float32(CAM_K[0, 2])))
    y = int(np.floor(np.float32(0.1) * np.float32(CAM_K[1, 1])
                     / np.float32(0.6) + np.float32(CAM_K[1, 2])))
    assert ours[y, x].item() == np.float32(0.6)
    # a tensor input stays on its device; no device means CUDA
    again = render.render_depth_points(torch.from_numpy(pts), CAM_K)
    assert torch.equal(again, ours)


def test_render_depth_points_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.render_depth_points(_splat_points(), CAM_K)


# ---------------------------------------------------------------- designator

def _bumpy_cloud(n_side=24):
    """A plane with two sharp z-bumps — clear scale-space extrema."""
    xs = np.linspace(0, 1, n_side)
    g = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    z = (0.5 * np.exp(-np.sum((g - [0.3, 0.3]) ** 2, 1) / 0.004)
         - 0.5 * np.exp(-np.sum((g - [0.75, 0.6]) ** 2, 1) / 0.004))
    return np.concatenate([g, z[:, None]], axis=1)


SIFT_PARAMS = dict(min_scale=0.02, n_octaves=3, n_scales_per_octave=4,
                   min_contrast=0.05)


def test_sift3d_numpy_matches_jax():
    pts = _bumpy_cloud()
    kp = dsg.sift3d_numpy(pts, **SIFT_PARAMS)
    np.testing.assert_array_equal(kp, jax_dsg.sift3d_numpy(pts,
                                                           **SIFT_PARAMS))
    assert len(kp) >= 2
    assert np.linalg.norm(kp[:, :2] - [0.3, 0.3], axis=1).min() < 0.1
    assert np.linalg.norm(kp[:, :2] - [0.75, 0.6], axis=1).min() < 0.1


def test_native_designator_matches_jax(tmp_path):
    """The port builds its own binary into betapose_tpu_torch/_build/ (not
    next to the source); it writes the keypoint file the JAX package's
    binary writes, and the numpy twin's keypoints to 1e-4."""
    binary = dsg.build_native()
    if binary is None:
        pytest.skip("no C++ toolchain")
    pkg = os.path.dirname(os.path.abspath(dsg.__file__))
    assert binary == os.path.join(os.path.dirname(os.path.dirname(pkg)),
                                  "_build", "sift3d")
    assert not os.path.exists(os.path.join(pkg, "sift3d"))
    pts = _bumpy_cloud()
    in_ply = str(tmp_path / "in.ply")
    plyio.write_vertices_ascii(in_ply, pts)
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "jax.ply")
    dsg.designate(in_ply, ours, use_native=True, **SIFT_PARAMS)
    if jax_dsg.build_native() is None:
        pytest.skip("the JAX package's binary did not build")
    jax_dsg.designate(in_ply, theirs, use_native=True, **SIFT_PARAMS)
    kp = plyio.read_vertices(ours)
    np.testing.assert_array_equal(kp, plyio.read_vertices(theirs))
    kp_np = dsg.sift3d_numpy(pts, **SIFT_PARAMS)
    assert len(kp) > 0
    d = np.array([np.linalg.norm(kp_np - k, axis=1).min() for k in kp])
    assert np.median(d) < 1e-4


def test_designator_cli_numpy_path(tmp_path):
    pts = _bumpy_cloud()
    in_ply, out_ply = str(tmp_path / "in.ply"), str(tmp_path / "kp.ply")
    jax_ply = str(tmp_path / "jax.ply")
    plyio.write_vertices_ascii(in_ply, pts)
    dsg.designate(in_ply, out_ply, use_native=False, **SIFT_PARAMS)
    jax_dsg.designate(in_ply, jax_ply, use_native=False, **SIFT_PARAMS)
    with open(out_ply) as a, open(jax_ply) as b:
        assert a.read() == b.read()
    assert plyio.read_vertices(out_ply).shape[1] == 3
    assert dsg.main([]) == 1                     # usage line, no work


# ----------------------------------------------------------------- annotator

def _annotate(mod, sixd, out_base, seed=0):
    from betapose_tpu.data.annot import read_annot_h5
    args = mod.make_parser().parse_args([
        "--obj_id", "1", "--total_kp_number", "20", "--train_split", "2",
        "--output_base", out_base, "--sixd_base", sixd, "--seed",
        str(seed)])
    out_dir = mod.run(args)
    return out_dir, [read_annot_h5(os.path.join(out_dir, f"annot_{t}.h5"))
                     for t in ("train", "eval")]


def test_annotator_cli_matches_jax(tmp_path):
    """The CLI on a synthetic SIXD tree writes annot_{train,eval}.h5,
    per-frame bbox/kp .npy files and the split images array-equal to the
    JAX package's CLI."""
    sixd = make_synthetic_sixd(tmp_path, n_frames=4)
    ours_dir, ours = _annotate(annotator, sixd,
                               str(tmp_path / "ours") + os.sep)
    theirs_dir, theirs = _annotate(jax_annot, sixd,
                                   str(tmp_path / "jax") + os.sep)
    for (n1, b1, p1), (n2, b2, p2) in zip(ours, theirs):
        assert list(n1) == list(n2)
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(p1, p2)
    assert len(ours[0][0]) == 2 and ours[0][2].shape[1:] == (20, 2)
    for sub in ("bbox", "kp_label", "train", "eval"):
        names = sorted(os.listdir(os.path.join(ours_dir, sub)))
        assert names == sorted(os.listdir(os.path.join(theirs_dir, sub)))
        for n in names:
            if n.endswith(".npy"):
                np.testing.assert_array_equal(
                    np.load(os.path.join(ours_dir, sub, n)),
                    np.load(os.path.join(theirs_dir, sub, n)))


def test_annotate_frame_exact_matches_jax():
    """annotate_frame and annotate_frame_exact equal the JAX package's,
    and the exact one is the pinhole projection."""
    rng = np.random.default_rng(8)
    verts = rng.uniform(-0.04, 0.04, (400, 3))
    kps = verts[:20]
    for r in _rotations(9, 3):
        pose = np.eye(4)
        pose[:3, :3] = r
        pose[:3, 3] = [0.02, -0.01, 0.6]
        a = annotator.annotate_frame_exact(pose, verts, kps, CAM_K)
        b = jax_annot.annotate_frame_exact(pose, verts, kps, CAM_K)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        a = annotator.annotate_frame(pose, [200, 150, 380, 330], verts,
                                     kps, CAM_K)
        b = jax_annot.annotate_frame(pose, [200, 150, 380, 330], verts,
                                     kps, CAM_K)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        _, kp_img = annotator.annotate_frame_exact(pose, verts, kps, CAM_K)
        kp_cam = kps @ pose[:3, :3].T + pose[:3, 3]
        np.testing.assert_allclose(
            kp_img, annotator.project_points(kp_cam, CAM_K), atol=1e-9)


# ------------------------------------------------------------------ watchdog

@pytest.mark.parametrize("case", ["fires", "beat", "disabled", "yields",
                                  "claim_lifecycle"])
def test_watchdog(case, tmp_path):
    """The JAX package's watchdog tests, on the port's copy (an injected
    exit_fn stands in for os._exit)."""
    fired, codes = threading.Event(), []

    def fake_exit(code):
        codes.append(code)
        fired.set()

    claim = str(tmp_path / "claim")
    if case == "fires":
        with wd_mod.StallWatchdog(0.2, label="t", exit_code=7,
                                  check_every=0.05, exit_fn=fake_exit):
            assert fired.wait(2.0), "watchdog never fired"
        assert codes == [7]
    elif case == "beat":
        with wd_mod.StallWatchdog(0.3, check_every=0.05,
                                  exit_fn=fake_exit) as wd:
            for _ in range(10):
                time.sleep(0.1)
                wd.beat()
            assert not fired.is_set()
        time.sleep(0.5)
        assert not fired.is_set()
    elif case == "disabled":
        with wd_mod.StallWatchdog(0.0, exit_fn=fake_exit) as wd:
            assert not wd.enabled and wd._thread is None
            time.sleep(0.1)
        assert codes == []
    elif case == "yields":
        with wd_mod.StallWatchdog(30.0, check_every=0.05, exit_fn=fake_exit,
                                  yield_to=claim) as wd:
            wd.beat()
            time.sleep(0.2)
            assert not fired.is_set()
            wd_mod.claim_chip(label="bench", path=claim)
            assert fired.wait(2.0), "never yielded to the claim"
        assert codes == [4]
    else:
        assert not wd_mod.chip_claimed(claim)
        wd_mod.claim_chip(label="bench", path=claim)
        assert wd_mod.chip_claimed(claim)
        old = time.time() - 3600
        os.utime(claim, (old, old))
        assert not wd_mod.chip_claimed(claim)
        wd_mod.release_chip(claim)
        assert not wd_mod.chip_claimed(claim)
        wd_mod.release_chip(claim)          # idempotent


def test_chip_claim_path_is_in_the_temporary_directory(tmp_path,
                                                        monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert wd_mod.chip_claim_path() == str(tmp_path / "betapose_chip_claim")
    assert not wd_mod.chip_claimed()
    wd_mod.claim_chip("t")
    assert wd_mod.chip_claimed()
    wd_mod.release_chip()
    assert not wd_mod.chip_claimed()
