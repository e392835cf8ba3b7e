"""Stage 1 — keypoint designator (3D SIFT over a mesh point cloud).

Drives the native `sift3d` C++ tool (built on demand from sift3d.cpp) with
the reference CLI shape `pcl-sift <in.ply> <out.ply> [vis]`
(`1_keypoint_designator/main.cpp:76-88`, `build_and_run.sh`).  A numpy
implementation of the same algorithm (`sift3d_numpy`) backs the tests and
serves as a fallback when no C++ toolchain is present.

A copy of the JAX package's designator.  `build_native` writes the binary
into `betapose_tpu_torch/_build/` (listed in `.gitignore`), not next to
the source.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sift3d.cpp")
_BIN = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build",
                    "sift3d")


def build_native(force: bool = False) -> str | None:
    """Compile sift3d.cpp with g++ -O3. Returns binary path or None."""
    if os.path.exists(_BIN) and not force and \
            os.path.getmtime(_BIN) >= os.path.getmtime(_SRC):
        return _BIN
    import shutil
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return None
    os.makedirs(os.path.dirname(_BIN), exist_ok=True)
    tmp = f"{_BIN}.{os.getpid()}.tmp"   # concurrent builds never share it
    cmd = [gxx, "-O3", "-std=c++17", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        sys.stderr.write(e.stderr.decode())
        return None
    os.replace(tmp, _BIN)
    return _BIN


def sift3d_numpy(points: np.ndarray, min_scale: float = 0.01,
                 n_octaves: int = 10, n_scales_per_octave: int = 5,
                 min_contrast: float = 0.2) -> np.ndarray:
    """Numpy twin of the native implementation (pcl::SIFTKeypoint
    semantics on the z field).  O(N * neighbors) per octave — fine for the
    test-sized clouds; use the native binary for full meshes."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    field = pts[:, 2].copy()
    tree = cKDTree(pts)
    n = len(pts)
    k = min(25, n)
    _, knn_idx = tree.query(pts, k=k)
    if k == 1:
        knn_idx = knn_idx[:, None]

    keypoints = []
    scale = min_scale
    for _ in range(n_octaves):
        s = n_scales_per_octave
        scales = scale * np.power(2.0, (np.arange(s + 3) - 1) / s)
        max_radius = 2.0 * scales[-1]
        neighbors = tree.query_ball_point(pts, r=max_radius)
        smoothed = np.zeros((s + 3, n))
        for i in range(n):
            nn = np.asarray(neighbors[i])
            d2 = np.sum((pts[nn] - pts[i]) ** 2, axis=1)
            for si, sg in enumerate(scales):
                w = np.exp(-d2 / (2.0 * sg * sg))
                den = w.sum()
                smoothed[si, i] = (field[nn] * w).sum() / den if den > 0 \
                    else field[i]
        dog = smoothed[1:] - smoothed[:-1]              # [s+2, n]
        for i in range(n):
            nn = knn_idx[i]
            for si in range(1, dog.shape[0] - 1):
                v = dog[si, i]
                if abs(v) < min_contrast:
                    continue
                window = dog[si - 1:si + 2][:, nn]      # [3, k]
                others = window.flatten()
                center_pos = 1 * len(nn) + int(np.where(nn == i)[0][0]) \
                    if i in nn else None
                vals = np.delete(others, center_pos) \
                    if center_pos is not None else others
                if np.all(vals < v) or np.all(vals > v):
                    keypoints.append(pts[i])
                    break
        scale *= 2.0
    if not keypoints:
        return np.zeros((0, 3))
    return np.asarray(keypoints)


def designate(in_ply: str, out_ply: str, use_native: bool = True, **params):
    """Run the designator: in_ply mesh -> out_ply ascii keypoint cloud."""
    if use_native:
        binary = build_native()
        if binary is not None:
            env = dict(os.environ)
            for k, ev in (("min_scale", "SIFT3D_MIN_SCALE"),
                          ("n_octaves", "SIFT3D_OCTAVES"),
                          ("n_scales_per_octave", "SIFT3D_SCALES"),
                          ("min_contrast", "SIFT3D_MIN_CONTRAST")):
                if k in params:
                    env[ev] = str(params[k])
            subprocess.run([binary, in_ply, out_ply], check=True, env=env)
            return out_ply
    from betapose_tpu_torch.data import ply as plyio
    pts = plyio.read_vertices(in_ply)
    kp = sift3d_numpy(pts, **params)
    plyio.write_vertices_ascii(out_ply, kp)
    return out_ply


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: designator <in.ply> <out.ply> [vis]")
        return 1
    designate(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
