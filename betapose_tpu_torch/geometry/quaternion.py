"""Quaternion algebra (the subset of the vendored pyquaternion the reference
uses — `utils/pyquaternion.py`, consumed by `utils/metrics.py:63-67`).
A copy of the JAX package's `geometry/quaternion.py` (it uses no
framework), which the port does not import.

(w, x, y, z) convention; clean numpy implementation."""

from __future__ import annotations

import numpy as np


class Quaternion:
    __slots__ = ("q",)

    def __init__(self, *args, matrix=None, axis=None, angle=None, **kw):
        if matrix is not None:
            self.q = _from_matrix(np.asarray(matrix, np.float64))
        elif axis is not None and angle is not None:
            axis = np.asarray(axis, np.float64)
            axis = axis / np.linalg.norm(axis)
            half = angle / 2.0
            self.q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
        elif len(args) == 1:
            a = np.asarray(args[0], np.float64).reshape(-1)
            if a.size != 4:
                raise ValueError("expected 4 components")
            self.q = a.copy()
        elif len(args) == 4:
            self.q = np.asarray(args, np.float64)
        elif not args:
            self.q = np.array([1.0, 0, 0, 0])
        else:
            raise ValueError("bad Quaternion arguments")

    # -- properties ---------------------------------------------------------
    @property
    def w(self):
        return self.q[0]

    @property
    def vector(self):
        return self.q[1:]

    @property
    def norm(self):
        return float(np.linalg.norm(self.q))

    @property
    def conjugate(self):
        return Quaternion(self.q[0], -self.q[1], -self.q[2], -self.q[3])

    @property
    def inverse(self):
        n2 = float(np.dot(self.q, self.q))
        c = self.conjugate
        return Quaternion(c.q / n2)

    @property
    def normalised(self):
        return Quaternion(self.q / self.norm)

    @property
    def angle(self):
        """Rotation angle in radians, in [0, pi]... signed like pyquaternion
        (2*atan2(|v|, w))."""
        return float(2.0 * np.arctan2(np.linalg.norm(self.q[1:]), self.q[0]))

    @property
    def radians(self):
        return self.angle

    @property
    def degrees(self):
        return float(np.degrees(self.angle))

    @property
    def axis(self):
        v = self.q[1:]
        n = np.linalg.norm(v)
        return v / n if n > 1e-12 else np.array([0.0, 0.0, 1.0])

    @property
    def rotation_matrix(self):
        w, x, y, z = self.normalised.q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])

    # -- ops ----------------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Quaternion):
            w1, x1, y1, z1 = self.q
            w2, x2, y2, z2 = other.q
            return Quaternion(
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2)
        return Quaternion(self.q * float(other))

    def rotate(self, v):
        v = np.asarray(v, np.float64)
        return self.rotation_matrix @ v

    @staticmethod
    def slerp(q0: "Quaternion", q1: "Quaternion", amount: float):
        a = q0.normalised.q
        b = q1.normalised.q
        dot = float(np.dot(a, b))
        if dot < 0:
            b = -b
            dot = -dot
        if dot > 0.9995:
            out = a + amount * (b - a)
            return Quaternion(out / np.linalg.norm(out))
        theta0 = np.arccos(np.clip(dot, -1, 1))
        theta = theta0 * amount
        s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
        s1 = np.sin(theta) / np.sin(theta0)
        return Quaternion(s0 * a + s1 * b)

    def __repr__(self):
        return "Quaternion({:.6f}, {:.6f}, {:.6f}, {:.6f})".format(*self.q)

    def __eq__(self, other):
        return np.allclose(self.q, other.q)


def _from_matrix(m):
    """Rotation matrix (3x3 or 4x4) -> quaternion (Shepperd)."""
    m = m[:3, :3]
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    if m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                         (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    if m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        return np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                         0.25 * s, (m[1, 2] + m[2, 1]) / s])
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    return np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                     (m[1, 2] + m[2, 1]) / s, 0.25 * s])
