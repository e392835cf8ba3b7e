"""The PyTorch port's PnP against the JAX package (`betapose_tpu/ops/pnp.py`)
and cv2.solvePnP, on the cases of tests/test_pnp.py.

Poses are compared in METRIC space (ADD on the keypoint cloud, rotation
angle, translation), never entry by entry on R: LineMod objects span a few
degrees of field of view, so the reprojection objective has a near-twin
pose ~1e-3 apart in rotation, and float32 solvers may land on either."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from betapose_tpu.geometry import metrics  # noqa: E402
from betapose_tpu.ops import pnp as jax_pnp  # noqa: E402
from betapose_tpu_torch.ops import pnp as port_pnp  # noqa: E402

CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]])


def _rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _make_problem(rng, n=50, noise=0.0, t=None, scale=0.05, outliers=0):
    pts3d = rng.standard_normal((n, 3)) * scale
    R = _rotation(rng)
    if t is None:
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                      rng.uniform(0.6, 1.2)])
    pc = pts3d @ R.T + t
    uv = (CAM_K @ pc.T).T
    uv = uv[:, :2] / uv[:, 2:3]
    uv = uv + rng.standard_normal(uv.shape) * noise
    bad = rng.choice(n, outliers, replace=False)
    uv[bad] += rng.standard_normal((outliers, 2)) * 60.0
    return pts3d, uv, R, t, bad


def _pose(R, t):
    p = np.eye(4)
    p[:3, :3] = np.asarray(R)
    p[:3, 3] = np.asarray(t).ravel()
    return p


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _port(fn, p3, uv, **kw):
    R, t = fn(_t(p3), _t(uv), _t(CAM_K), **kw)
    return R.numpy(), t.numpy()


def _reproj_rms(R, t, pts3d, uv):
    pc = pts3d @ np.asarray(R).T + np.asarray(t).ravel()
    proj = (CAM_K @ pc.T).T
    return float(np.sqrt(np.mean(np.sum(
        (proj[:, :2] / proj[:, 2:3] - uv) ** 2, axis=1))))


def _same_pose(a, b, pts3d, add_m=1e-4, rot_deg=0.5):
    pa, pb = _pose(*a), _pose(*b)
    assert metrics.add_err(pa, pb, pts3d) < add_m
    assert metrics.rot_error(pa, pb) < rot_deg


def test_exact_recovery():
    pts3d, uv, R, t, _ = _make_problem(np.random.default_rng(0))
    Rp, tp = _port(port_pnp.solve_pnp, pts3d, uv)
    assert metrics.rot_error(_pose(R, t), _pose(Rp, tp)) < 0.5
    assert np.linalg.norm(tp - t) < 1e-3
    assert _reproj_rms(Rp, tp, pts3d, uv) < 0.1
    assert metrics.add_err(_pose(R, t), _pose(Rp, tp), pts3d) < 1e-3


@pytest.mark.parametrize("seed", range(5))
def test_matches_jax_and_cv2_with_noise(seed):
    pts3d, uv, _, _, _ = _make_problem(np.random.default_rng(seed), noise=2.0)
    _, rvec, tvec = cv2.solvePnP(pts3d, np.ascontiguousarray(uv)
                                 .reshape(-1, 1, 2), CAM_K,
                                 np.zeros((8, 1), np.float32))
    R_cv, _ = cv2.Rodrigues(rvec)
    Rj, tj = jax_pnp.solve_pnp(jnp.asarray(pts3d, jnp.float32),
                               jnp.asarray(uv, jnp.float32),
                               jnp.asarray(CAM_K, jnp.float32))
    Rp, tp = _port(port_pnp.solve_pnp, pts3d, uv)
    _same_pose((Rp, tp), (np.asarray(Rj), np.asarray(tj)), pts3d)
    _same_pose((Rp, tp), (R_cv, tvec), pts3d, add_m=1e-3, rot_deg=1.0)
    assert _reproj_rms(Rp, tp, pts3d, uv) <= \
        _reproj_rms(R_cv, tvec, pts3d, uv) * 1.02 + 1e-3


def test_batched_equals_one_by_one():
    problems = [_make_problem(np.random.default_rng(s)) for s in range(4)]
    p3 = np.stack([p[0] for p in problems])
    p2 = np.stack([p[1] for p in problems])
    Rb, tb = _port(port_pnp.solve_pnp, p3, p2, iters=12)
    for i, (pts3d, uv, R, t, _) in enumerate(problems):
        R1, t1 = _port(port_pnp.solve_pnp, pts3d, uv, iters=12)
        _same_pose((Rb[i], tb[i]), (R1, t1), pts3d, add_m=1e-6, rot_deg=1e-3)
        assert metrics.add_err(_pose(R, t), _pose(Rb[i], tb[i]),
                               pts3d) < 1e-3


def test_rodrigues_against_cv2_jax_and_roundtrip():
    rng = np.random.default_rng(11)
    rvecs = rng.standard_normal((6, 3))
    rvecs[5] = [np.pi, 0.0, 0.0]             # the theta ~ pi branch
    R = port_pnp.rodrigues(_t(rvecs)).numpy()
    for i, r in enumerate(rvecs):
        np.testing.assert_allclose(R[i], cv2.Rodrigues(r)[0], atol=1e-6)
        np.testing.assert_allclose(
            R[i], np.asarray(jax_pnp.rodrigues(jnp.asarray(r, jnp.float32))),
            atol=1e-6)
    back = port_pnp.inverse_rodrigues(_t(R))
    np.testing.assert_allclose(port_pnp.rodrigues(back).numpy(), R,
                               atol=1e-5)
    np.testing.assert_array_equal(
        port_pnp.rodrigues(torch.zeros(3)).numpy(), np.eye(3))


def test_dlt_is_indifferent_to_the_svd_sign(monkeypatch):
    """An SVD is free to return (-U, S, -Vh): the null vector flips, and the
    depth test must undo it."""
    pts3d, uv, _, _, _ = _make_problem(np.random.default_rng(2), noise=1.0)
    obs = port_pnp._normalize_obs(_t(uv)[None], _t(CAM_K))
    R1, t1 = port_pnp._dlt_init(_t(pts3d)[None], obs)
    svd = torch.linalg.svd

    def flipped(a, full_matrices=True):
        u, s, vh = svd(a, full_matrices=full_matrices)
        return -u, s, -vh

    monkeypatch.setattr(torch.linalg, "svd", flipped)
    R2, t2 = port_pnp._dlt_init(_t(pts3d)[None], obs)
    np.testing.assert_allclose(R2.numpy(), R1.numpy(), atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), t1.numpy(), atol=1e-6)


def test_robust_recovers_gross_outliers():
    """~20% grossly wrong points: trimmed IRLS lands within 1 cm ADD."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        pts3d, uv, R, t, _ = _make_problem(
            rng, n=26, noise=1.0, t=np.array([0.02, -0.03, 0.55]),
            scale=0.04, outliers=5)
        Rp, tp = _port(port_pnp.solve_pnp_robust, pts3d, uv)
        assert metrics.add_err(_pose(R, t), _pose(Rp, tp), pts3d) < 0.01


def test_robust_matches_jax_and_plain_without_outliers():
    pts3d, uv, _, _, _ = _make_problem(
        np.random.default_rng(4), n=30, t=np.array([0.01, 0.02, 0.6]))
    Rr, tr = _port(port_pnp.solve_pnp_robust, pts3d, uv)
    Rp, tp = _port(port_pnp.solve_pnp, pts3d, uv)
    Rj, tj = jax_pnp.solve_pnp_robust(jnp.asarray(pts3d, jnp.float32),
                                      jnp.asarray(uv, jnp.float32),
                                      jnp.asarray(CAM_K, jnp.float32))
    _same_pose((Rr, tr), (Rp, tp), pts3d)
    _same_pose((Rr, tr), (np.asarray(Rj), np.asarray(tj)), pts3d)


def test_weight_ones_is_bitwise_unweighted():
    pts3d, uv, _, _, _ = _make_problem(np.random.default_rng(5), n=26,
                                       noise=2.0)
    R1, t1 = _port(port_pnp.solve_pnp_robust, pts3d, uv, rounds=2)
    R2, t2 = _port(port_pnp.solve_pnp_robust, pts3d, uv, rounds=2,
                   w=_t(np.ones(26)))
    np.testing.assert_array_equal(R1, R2)
    np.testing.assert_array_equal(t1, t2)


def test_score_weighted_survives_heavy_outliers_like_jax():
    rng = np.random.default_rng(6)
    for _ in range(3):
        pts3d, uv, R, t, bad = _make_problem(
            rng, n=26, noise=1.0, t=np.array([0.02, -0.03, 0.55]),
            scale=0.04, outliers=9)
        score = rng.uniform(0.7, 1.0, 26)
        score[bad] = rng.uniform(0.05, 0.25, 9)
        w = score ** 4
        Rp, tp = _port(port_pnp.solve_pnp_robust, pts3d, uv, rounds=2,
                       w=_t(w))
        Rj, tj = jax_pnp.solve_pnp_robust(
            jnp.asarray(pts3d, jnp.float32), jnp.asarray(uv, jnp.float32),
            jnp.asarray(CAM_K, jnp.float32), rounds=2,
            w=jnp.asarray(w, jnp.float32))
        assert metrics.add_err(_pose(R, t), _pose(Rp, tp), pts3d) < 0.01
        _same_pose((Rp, tp), (np.asarray(Rj), np.asarray(tj)), pts3d,
                   add_m=1e-3, rot_deg=1.0)


def test_depth_prior_matches_jax_and_pulls_depth():
    pts3d, uv, R, t, _ = _make_problem(np.random.default_rng(1), noise=2.0)
    _, tq = _port(port_pnp.solve_pnp_robust, pts3d, uv, rounds=2,
                  z_prior=torch.tensor(2.0), z_lambda=1e4)
    assert abs(float(tq[2]) - 2.0) < 0.05
    w = np.random.default_rng(2).random(50)
    kw = dict(rounds=2, z_lambda=2.0)
    Rp, tp = _port(port_pnp.solve_pnp_robust, pts3d, uv, w=_t(w),
                   z_prior=torch.tensor(float(t[2])), **kw)
    Rj, tj = jax_pnp.solve_pnp_robust(
        jnp.asarray(pts3d, jnp.float32), jnp.asarray(uv, jnp.float32),
        jnp.asarray(CAM_K, jnp.float32), w=jnp.asarray(w, jnp.float32),
        z_prior=jnp.asarray(t[2], jnp.float32), **kw)
    _same_pose((Rp, tp), (np.asarray(Rj), np.asarray(tj)), pts3d)
    assert metrics.add_err(_pose(R, t), _pose(Rp, tp), pts3d) < 0.01
