"""Assorted geometry/data helpers — parity with the reference's grab-bag
`utils/utils.py` (the live subset; the dead MXNet-era pose-pool builders are
intentionally not reproduced — see SURVEY.md 2.8).  A copy of the JAX
package's `geometry/utils.py` on the port's `data/ply`.
"""

from __future__ import annotations

import numpy as np

from betapose_tpu_torch.data import ply as plyio


def trans_vertices_by_pose(vertices, pose):
    """Apply a 4x4 pose to (N,3) vertices (`utils/utils.py:107-116`)."""
    v = np.asarray(vertices, np.float64)
    pose = np.asarray(pose)
    return v @ pose[:3, :3].T + pose[:3, 3]


def get_bbox_from_mask(mask, KP=False):
    """Mask -> (xmin, xmax, ymin, ymax), -1s when empty
    (`utils/utils.py:141-157`)."""
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask.any(axis=2)
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if rows.any():
        ymin, ymax = np.where(rows)[0][[0, -1]]
        xmin, xmax = np.where(cols)[0][[0, -1]]
        return int(xmin), int(xmax), int(ymin), int(ymax)
    return -1, -1, -1, -1


def jitter_bbox(bbox, jitter, rng=None):
    """Randomly jitter an [xmin, ymin, xmax, ymax] box
    (`utils/utils.py:122-139`)."""
    rng = rng or np.random.default_rng()
    bbox = list(bbox)
    oh = bbox[3] - bbox[1]
    ow = bbox[2] - bbox[0]
    dw, dh = ow * jitter, oh * jitter
    return [bbox[0] + int(rng.uniform(-dw, dw)),
            bbox[1] + int(rng.uniform(-dh, dh)),
            bbox[2] + int(rng.uniform(-dw, dw)),
            bbox[3] + int(rng.uniform(-dh, dh))]


def generate_mask_img(depth, if_all_black=True):
    """Depth map -> mask image (`utils/utils.py:219-236`), vectorized."""
    depth = np.asarray(depth)
    occupied = depth != 0
    img = np.zeros(depth.shape + (3,), np.float64)
    img[occupied] = 255.0 if if_all_black else 0.0
    if not if_all_black:
        img[occupied] = depth[occupied][:, None]
    return img


def handle_occlusion(real_kp_depth, real_kp_label, real_all_depth,
                     occluded_offset: int = 66):
    """Zero out keypoint-depth pixels that a closer surface occludes, and
    mark their labels with +66 (`utils/utils.py:43-57`), vectorized."""
    kp_depth = np.asarray(real_kp_depth).copy()
    kp_label = np.asarray(real_kp_label).copy()
    all_depth = np.asarray(real_all_depth)
    occluded = (kp_depth[..., 0] > 0) & (all_depth[..., 0] == 1)
    kp_depth[occluded] = 0
    kp_label[occluded] = kp_label[occluded] + occluded_offset
    return kp_depth, kp_label


def local_top_visibility(kp_xy, kp_z, depth_map, radius: int = 5,
                         threshold: float = 15.0):
    """Keypoint visibility by depth-buffer comparison: a keypoint is visible
    if no rendered surface within `radius` px is more than `threshold`
    (same units as depth) in front of it.  Vectorized realization of the
    local-top idea the reference sketched (`utils/utils.py:59-100`,
    commented out there; the annotator instead relies on the mask-bbox
    remap).  Returns a boolean (K,) visibility mask."""
    h, w = depth_map.shape
    xi = np.round(np.asarray(kp_xy)[:, 0]).astype(int)
    yi = np.round(np.asarray(kp_xy)[:, 1]).astype(int)
    vis = np.ones(len(xi), bool)
    for k in range(len(xi)):
        x, y = xi[k], yi[k]
        if not (0 <= x < w and 0 <= y < h):
            vis[k] = False
            continue
        y0, y1 = max(0, y - radius), min(h, y + radius + 1)
        x0, x1 = max(0, x - radius), min(w, x + radius + 1)
        window = depth_map[y0:y1, x0:x1]
        front = window[(window > 0) & (window < kp_z[k] - threshold)]
        vis[k] = front.size == 0
    return vis


def output_pointcloud(vertices, filename="output.ply"):
    """Write an (N,3) cloud as ascii ply (`utils/utils.py:446-471`)."""
    plyio.write_vertices_ascii(filename, np.asarray(vertices))
    return filename
