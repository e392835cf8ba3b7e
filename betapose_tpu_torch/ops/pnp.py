"""Batched Perspective-n-Point solver in PyTorch, float32.

Counterpart of `betapose_tpu/ops/pnp.py` (the reference's `cv2.solvePnP`,
iterative LM, `utils/utils.py:17-41`): a Hartley-normalized DLT
initialization (SVD of the [2N,12] design matrix) followed by a fixed
number of Levenberg-Marquardt steps on axis-angle + translation against
normalized-coordinate residuals, with analytic Jacobians and a QR-solved
damped step.  The JAX `vmap` is the leading batch dimension here and its
`lax.scan` a Python loop over all problems at once.

Everything runs in float32; matmuls on the card are true float32 because
TF32 is off (`core/device.py`).
"""

from __future__ import annotations

import torch


def _eye(batch_shape, ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(
        *batch_shape, 3, 3)


def _hat(v):
    """[...,3] -> the cross-product matrices [...,3,3]."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)], dim=-2)


def rodrigues(rvec):
    """Axis-angle [...,3] -> rotation matrices [...,3,3]."""
    theta = torch.linalg.vector_norm(rvec, dim=-1)
    small = theta < 1e-12
    k = rvec / torch.where(small, torch.ones_like(theta), theta)[..., None]
    K = _hat(k)
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    eye = _eye(rvec.shape[:-1], rvec)
    R = eye + s * K + (1.0 - c) * (K @ K)
    return torch.where(small[..., None, None], eye, R)


def inverse_rodrigues(R):
    """Rotation matrices [...,3,3] -> axis-angle [...,3]; theta ~ pi takes
    the axis from the diagonal of R."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    vnorm = torch.linalg.vector_norm(v, dim=-1)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = ((trace - 1.0) / 2.0).clamp(-1.0, 1.0)
    theta = torch.atan2(vnorm / 2.0, cos_theta)
    axis = v / torch.where(vnorm < 1e-8, torch.ones_like(vnorm),
                           vnorm)[..., None]
    generic = axis * theta[..., None]
    d = ((torch.diagonal(R, dim1=-2, dim2=-1) + 1.0) / 2.0).clamp_min(0.0)
    d = torch.sqrt(d)
    one = torch.ones_like(vnorm)
    signs = torch.stack([one, torch.where(R[..., 0, 1] < 0, -one, one),
                         torch.where(R[..., 0, 2] < 0, -one, one)], dim=-1)
    axis_pi = d * signs
    axis_pi = axis_pi / torch.linalg.vector_norm(
        axis_pi, dim=-1, keepdim=True).clamp_min(1e-12)
    out = torch.where((vnorm < 1e-5)[..., None], axis_pi * theta[..., None],
                      generic)
    return torch.where((theta < 1e-8)[..., None], torch.zeros_like(out), out)


def _dlt_init(pts3d, pts2d_norm, w=None):
    """DLT estimate of [R|t] from normalized image coordinates, with
    (weighted) Hartley normalization of both point sets so the design
    matrix stays well-conditioned in float32.

    pts3d [B,N,3]; pts2d_norm [B,N,2]; w: optional [B,N] nonnegative point
    weights (zero rows drop points with static shapes).  Returns
    (R [B,3,3], t [B,3]).  The null vector's sign is fixed by the depth test,
    so an SVD that returns it negated gives the same pose."""
    dtype, dev = pts3d.dtype, pts3d.device
    b, n, _ = pts3d.shape
    w = torch.ones((b, n), dtype=dtype, device=dev) if w is None \
        else w.to(dtype)
    wsum = w.sum(dim=1).clamp_min(1e-12)                          # [B]

    c3 = (pts3d * w[..., None]).sum(dim=1) / wsum[:, None]        # [B,3]
    p3 = pts3d - c3[:, None]
    s3 = (3.0 ** 0.5) / torch.sqrt(
        (w * (p3 * p3).sum(dim=2)).sum(dim=1) / wsum).clamp_min(1e-12)
    p3 = p3 * s3[:, None, None]
    c2 = (pts2d_norm * w[..., None]).sum(dim=1) / wsum[:, None]
    p2 = pts2d_norm - c2[:, None]
    s2 = (2.0 ** 0.5) / torch.sqrt(
        (w * (p2 * p2).sum(dim=2)).sum(dim=1) / wsum).clamp_min(1e-12)
    p2 = p2 * s2[:, None, None]

    X = torch.cat([p3, torch.ones((b, n, 1), dtype=dtype, device=dev)], dim=2)
    zeros = torch.zeros_like(X)
    u = p2[..., 0:1]
    v = p2[..., 1:2]
    sw = torch.sqrt(w)[..., None]
    rows_u = sw * torch.cat([X, zeros, -u * X], dim=2)            # [B,N,12]
    rows_v = sw * torch.cat([zeros, X, -v * X], dim=2)
    A = torch.cat([rows_u, rows_v], dim=1)                        # [B,2N,12]
    _, _, vh = torch.linalg.svd(A, full_matrices=True)
    Pn = vh[:, -1].reshape(b, 3, 4)

    # Denormalize: P = inv(T2) Pn T3
    z = torch.zeros_like(s3)
    o = torch.ones_like(s3)
    T3 = torch.stack([
        torch.stack([s3, z, z, -s3 * c3[:, 0]], dim=-1),
        torch.stack([z, s3, z, -s3 * c3[:, 1]], dim=-1),
        torch.stack([z, z, s3, -s3 * c3[:, 2]], dim=-1),
        torch.stack([z, z, z, o], dim=-1)], dim=1)
    T2_inv = torch.stack([
        torch.stack([1 / s2, z, c2[:, 0]], dim=-1),
        torch.stack([z, 1 / s2, c2[:, 1]], dim=-1),
        torch.stack([z, z, o], dim=-1)], dim=1)
    P = T2_inv @ Pn @ T3

    # points must lie in front of the camera
    centroid = pts3d.mean(dim=1)
    depth = (P[:, 2, :3] * centroid).sum(dim=1) + P[:, 2, 3]
    P = P * torch.where(depth < 0, -o, o)[:, None, None]
    M = P[:, :, :3]
    U, S, Vt = torch.linalg.svd(M)
    scale = S.mean(dim=1)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([o, o, torch.sign(det)], dim=-1))
    R = U @ D @ Vt
    t = P[:, :, 3] / scale[:, None]
    return R, t


def _normalize_obs(points_2d, cam_K):
    K = cam_K.to(points_2d.dtype)
    xn = (points_2d[..., 0] - K[0, 2]) / K[0, 0]
    yn = (points_2d[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([xn, yn], dim=-1)


def _lm_refine(pts3d, obs, R0, t0, iters, w=None, z_prior=None,
               z_lambda=0.0):
    """Weighted LM refinement from (R0, t0).  w: optional [B,N] weights
    (sqrt-applied to residual and Jacobian rows).  z_prior [B] / z_lambda:
    optional soft depth prior, one extra residual row
    sqrt(z_lambda) * (t_z - z_prior) / z_prior; z_prior=None skips the row."""
    dtype, dev = pts3d.dtype, pts3d.device
    b, n, _ = pts3d.shape
    sw = torch.ones((b, n), dtype=dtype, device=dev) if w is None \
        else torch.sqrt(w.to(dtype))
    sw2 = sw.repeat_interleave(2, dim=1)                   # (u,v) per point
    use_prior = z_prior is not None
    if use_prior:
        zp = torch.as_tensor(z_prior, dtype=dtype, device=dev).expand(b)
        pw = (torch.sqrt(torch.as_tensor(z_lambda, dtype=dtype, device=dev))
              / zp.clamp_min(1e-6))
        J_prior = torch.zeros((b, 1, 6), dtype=dtype, device=dev)
        J_prior[:, 0, 5] = pw

    def prior_res(t):
        return ((t[:, 2] - zp) * pw)[:, None]

    def residual(R, t):
        pc = pts3d @ R.transpose(1, 2) + t[:, None]        # [B,N,3]
        return pc[..., :2] / pc[..., 2:3] - obs, pc

    R, t = R0, t0
    lam = torch.full((b,), 1e-6, dtype=dtype, device=dev)
    for _ in range(iters):
        r, pc = residual(R, t)
        X, Y, Z = pc.unbind(-1)
        iz = 1.0 / Z
        iz2 = iz * iz
        zeros = torch.zeros_like(iz)
        dpi = torch.stack([
            torch.stack([iz, zeros, -X * iz2], dim=-1),
            torch.stack([zeros, iz, -Y * iz2], dim=-1)], dim=-2)  # [B,N,2,3]
        # left perturbation of R: dpc/d(dw) = -[pc - t]x, dpc/d(dt) = I
        J_w = dpi @ -_hat(pc - t[:, None])
        J = torch.cat([J_w, dpi], dim=-1).reshape(b, 2 * n, 6)
        J = J * sw2[..., None]
        rv = r.reshape(b, 2 * n) * sw2
        if use_prior:
            J = torch.cat([J, J_prior], dim=1)
            rv = torch.cat([rv, prior_res(t)], dim=1)
        # damped least squares via QR of the augmented system (cond(J), not
        # cond(J)^2 as the normal equations would give)
        col_norm = torch.sqrt((J * J).sum(dim=1))
        damp = torch.sqrt(lam)[:, None, None] * torch.diag_embed(
            col_norm + 1e-12)
        J_aug = torch.cat([J, damp], dim=1)
        r_aug = torch.cat([rv, torch.zeros((b, 6), dtype=dtype, device=dev)],
                          dim=1)
        Q, Rq = torch.linalg.qr(J_aug)
        step = torch.linalg.solve_triangular(
            Rq, (Q.transpose(1, 2) @ r_aug[..., None]), upper=True)[..., 0]
        R_new = rodrigues(-step[:, :3]) @ R
        t_new = t - step[:, 3:]
        r_new, _ = residual(R_new, t_new)
        e_new = ((r_new.reshape(b, 2 * n) * sw2) ** 2).sum(dim=1)
        if use_prior:
            e_new = e_new + (prior_res(t_new) ** 2).sum(dim=1)
        improved = e_new < (rv ** 2).sum(dim=1)
        R = torch.where(improved[:, None, None], R_new, R)
        t = torch.where(improved[:, None], t_new, t)
        lam = torch.where(improved, lam * 0.1, lam * 10.0).clamp(1e-14, 1e6)
    return R, t


def _batched(fn):
    """Let a solver over [B,N,...] problems also take one [N,...] problem."""
    def wrapper(points_3d, points_2d, cam_K, *args, **kwargs):
        single = points_3d.dim() == 2
        if single:
            points_3d, points_2d = points_3d[None], points_2d[None]
            kwargs = {k: (v[None] if k == "w" and v is not None else v)
                      for k, v in kwargs.items()}
        R, t = fn(points_3d, points_2d, cam_K, *args, **kwargs)
        return (R[0], t[0]) if single else (R, t)
    wrapper.__doc__ = fn.__doc__
    wrapper.__name__ = fn.__name__
    return wrapper


@_batched
def solve_pnp(points_3d, points_2d, cam_K, iters: int = 20):
    """Least-squares PnP (`cv2.solvePnP` semantics, zero distortion).

    points_3d [B,N,3] model points; points_2d [B,N,2] pixels; cam_K [3,3].
    Returns (R [B,3,3], t [B,3]); unbatched [N,...] inputs give [3,3], [3].
    """
    pts3d = points_3d.float()
    obs = _normalize_obs(points_2d.float(), cam_K)
    R0, t0 = _dlt_init(pts3d, obs)
    return _lm_refine(pts3d, obs, R0, t0, iters)


def _point_err(pts3d, obs, R, t):
    pc = pts3d @ R.transpose(1, 2) + t[:, None]
    return torch.linalg.vector_norm(pc[..., :2] / pc[..., 2:3] - obs, dim=-1)


@_batched
def solve_pnp_robust(points_3d, points_2d, cam_K, iters: int = 20,
                     rounds: int = 2, keep: float = 0.7, w=None,
                     z_prior=None, z_lambda=0.0):
    """Outlier-robust PnP by trimmed IRLS restarts (an extension; the
    reference's least squares is `solve_pnp`).

    Each round keeps the best `keep` quantile of points by reprojection error
    under the current pose (0/1 weights), restarts a weighted DLT + LM, and
    accepts it when the trimmed error improves.  w: optional [B,N]
    confidence weights applied to the first solve and multiplied into every
    trim mask.  z_prior [B] / z_lambda: soft depth prior on t_z in every LM
    refinement (not in the trimming)."""
    pts3d = points_3d.float()
    obs = _normalize_obs(points_2d.float(), cam_K)
    w0 = None if w is None else w.float()
    R0, t0 = _dlt_init(pts3d, obs, w0)
    R, t = _lm_refine(pts3d, obs, R0, t0, iters, w0, z_prior, z_lambda)
    for _ in range(rounds):
        err = _point_err(pts3d, obs, R, t)
        if w0 is None:
            thr = torch.quantile(err, keep, dim=1, keepdim=True)
            w2 = (err <= thr).float()
        else:
            thr = torch.quantile(
                torch.where(w0 > 0, err, torch.full_like(err, float("inf"))),
                keep, dim=1, keepdim=True)
            w2 = w0 * (err <= thr)
        R0w, t0w = _dlt_init(pts3d, obs, w2)
        R2, t2 = _lm_refine(pts3d, obs, R0w, t0w, iters, w2, z_prior,
                            z_lambda)
        e_old = (w2 * _point_err(pts3d, obs, R, t) ** 2).sum(dim=1)
        e_new = (w2 * _point_err(pts3d, obs, R2, t2) ** 2).sum(dim=1)
        better = e_new < e_old
        R = torch.where(better[:, None, None], R2, R)
        t = torch.where(better[:, None], t2, t)
    return R, t
