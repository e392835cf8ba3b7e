"""6D pose evaluation metrics (ADD, rotation/translation error, IoU, 2D
reprojection error).

Numeric parity with reference `utils/metrics.py`; vectorized numpy.  A copy
of the JAX package's `geometry/metrics.py`, which the port does not import.
"""

from __future__ import annotations

import numpy as np


def transform_points(points_3d: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply the [4x4] (or [3x4]) pose to (N,3) points."""
    return points_3d @ mat[:3, :3].T + mat[:3, 3]


def add_err(gt_pose, est_pose, model) -> float:
    """Mean vertex L2 distance between model transformed by the GT pose and by
    the estimated pose (`utils/metrics.py:10-22`)."""
    v_a = transform_points(model, gt_pose)
    v_b = transform_points(model, est_pose)
    return float(np.mean(np.linalg.norm(v_a - v_b, axis=1)))


def adds_err(gt_pose, est_pose, model) -> float:
    """ADD-S: symmetric-object variant — mean distance from each GT-transformed
    vertex to the closest estimated-transformed vertex."""
    v_a = transform_points(model, gt_pose)
    v_b = transform_points(model, est_pose)
    d = np.linalg.norm(v_a[:, None, :] - v_b[None, :, :], axis=2)
    return float(np.mean(d.min(axis=1)))


def matrix2quaternion(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion (Shepperd's method, matching
    `utils/metrics.py:36-62`)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s,
                         (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    if m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                         (m[0, 1] + m[1, 0]) / s,
                         (m[0, 2] + m[2, 0]) / s])
    if m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        return np.array([(m[0, 2] - m[2, 0]) / s,
                         (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                         (m[1, 2] + m[2, 1]) / s])
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    return np.array([(m[1, 0] - m[0, 1]) / s,
                     (m[0, 2] + m[2, 0]) / s,
                     (m[1, 2] + m[2, 1]) / s, 0.25 * s])


def rot_error(gt_pose, est_pose) -> float:
    """Absolute relative-rotation angle in degrees (`utils/metrics.py:35-67`)."""
    q_gt = matrix2quaternion(np.asarray(gt_pose)[:3, :3])
    q_est = matrix2quaternion(np.asarray(est_pose)[:3, :3])
    # q_gt * conj(q_est); quaternion angle = 2*atan2(|vec|, w)
    w1, x1, y1, z1 = q_gt
    # inverse of a unit quaternion is its conjugate
    n = np.dot(q_est, q_est)
    w2, x2, y2, z2 = q_est[0] / n, -q_est[1] / n, -q_est[2] / n, -q_est[3] / n
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    angle = 2.0 * np.arctan2(np.linalg.norm([x, y, z]), w)
    return float(np.abs(np.degrees(angle)))


def trans_error(gt_pose, est_pose):
    """(norm, per-axis abs) translation error (`utils/metrics.py:70-74`)."""
    diff = np.asarray(gt_pose)[:3, 3] - np.asarray(est_pose)[:3, 3]
    return float(np.linalg.norm(diff)), np.abs(diff)


def iou(gt_box, est_box) -> float:
    """Axis-aligned box IoU with [x1,y1,x2,y2] boxes (`utils/metrics.py:77-96`)."""
    xa = max(gt_box[0], est_box[0])
    ya = max(gt_box[1], est_box[1])
    xb = min(gt_box[2], est_box[2])
    yb = min(gt_box[3], est_box[3])
    if xb <= xa or yb <= ya:
        return 0.0
    inter = (xb - xa) * (yb - ya)
    area_a = (gt_box[2] - gt_box[0]) * (gt_box[3] - gt_box[1])
    area_b = (est_box[2] - est_box[0]) * (est_box[3] - est_box[1])
    return float(inter / float(area_a + area_b - inter))


def projection_error_2d(gt_pose, est_pose, model, cam) -> float:
    """Mean 2D reprojection distance of model vertices under the two poses
    (`utils/metrics.py:99-126`)."""
    gt_pose = np.asarray(gt_pose)[:3]
    est_pose = np.asarray(est_pose)[:3]
    mh = np.concatenate([model, np.ones((model.shape[0], 1))], axis=1)
    gt_2d = (cam @ gt_pose @ mh.T)
    est_2d = (cam @ est_pose @ mh.T)
    gt_2d = (gt_2d[:2] / gt_2d[2]).T
    est_2d = (est_2d[:2] / est_2d[2]).T
    return float(np.mean(np.linalg.norm(gt_2d - est_2d, axis=1)))
