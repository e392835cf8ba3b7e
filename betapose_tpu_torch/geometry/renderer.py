"""Offscreen model renderer.

Counterpart of the reference's vispy/OpenGL renderer (`utils/renderer.py`:
colored/textured GLSL programs, FBO, z-buffer -> metric depth in `finish`
(:137-150), `draw_model` (:152), `draw_boundingbox` (:170), intrinsics ->
GL projection `build_projection` (:183)) — with no GL dependency:

- `Renderer`: numpy barycentric z-buffer triangle rasterizer with per-vertex
  colors and the same camera convention (intrinsics K, model-to-camera pose).
  `finish()` returns (rgb float [0,1], depth in meters — already metric, no
  GL depth-buffer unprojection needed).
- `render_depth_points`: vertex splatting by scatter-min on a torch device
  — the z-buffer occupancy/depth map the annotator consumes.
- `build_projection`: the intrinsics->GL clip matrix (kept for API parity
  and for exporting to actual GL consumers).

A copy of the JAX package's `geometry/renderer.py`: the numpy host code
unchanged, and its jitted scatter-min `render_depth_points` as a torch
function on the given device, in float32 as the JAX package computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from betapose_tpu_torch.core.device import resolve_device


def build_projection(cam, x0, y0, w, h, nc, fc, window_coords="y_down"):
    """Intrinsics -> 4x4 OpenGL projection matrix (parity with
    `utils/renderer.py:183-221`)."""
    q = -(fc + nc) / float(fc - nc)
    qn = -2 * (fc * nc) / float(fc - nc)
    if window_coords == "y_up":
        proj = np.array([
            [2 * cam[0, 0] / w, -2 * cam[0, 1] / w,
             (-2 * cam[0, 2] + w + 2 * x0) / w, 0],
            [0, -2 * cam[1, 1] / h, (-2 * cam[1, 2] + h + 2 * y0) / h, 0],
            [0, 0, q, qn],
            [0, 0, -1, 0]])
    else:  # y_down (default in the reference)
        proj = np.array([
            [2 * cam[0, 0] / w, -2 * cam[0, 1] / w,
             (-2 * cam[0, 2] + w + 2 * x0) / w, 0],
            [0, 2 * cam[1, 1] / h, (2 * cam[1, 2] - h + 2 * y0) / h, 0],
            [0, 0, q, qn],
            [0, 0, -1, 0]])
    return proj.T


def project_to_pixels(verts_cam, cam):
    z = verts_cam[:, 2]
    x = verts_cam[:, 0] * cam[0, 0] / z + cam[0, 2]
    y = verts_cam[:, 1] * cam[1, 1] / z + cam[1, 2]
    return np.stack([x, y], axis=1), z


class Renderer:
    """Software z-buffer renderer with the reference Renderer's API shape."""

    def __init__(self, size=(640, 480), cam=None):
        self.w, self.h = int(size[0]), int(size[1])
        self.cam = np.eye(3) if cam is None else np.asarray(cam)
        self.clear()

    def clear(self):
        self.color = np.zeros((self.h, self.w, 3), np.float32)
        self.depth = np.full((self.h, self.w), np.inf, np.float32)

    def set_cam(self, cam):
        self.cam = np.asarray(cam)

    def draw_model(self, model, pose, ambient_weight: float = 0.5,
                   light=(0, 0, -1)):
        """Rasterize model (needs .vertices; .faces and .colors optional)
        under the 4x4 model-to-camera pose."""
        verts = np.asarray(model.vertices, np.float64)
        pose = np.asarray(pose)
        vc = verts @ pose[:3, :3].T + pose[:3, 3]
        faces = getattr(model, "faces", None)
        colors = getattr(model, "colors", None)
        if colors is None:
            colors = np.full((len(verts), 3), 0.5, np.float32)
        if faces is None:
            # point splatting fallback
            xy, z = project_to_pixels(vc, self.cam)
            self._splat(xy, z, colors)
            return
        # UV-textured path (reference's textured program,
        # utils/renderer.py:50-85): models carrying texcoord+texture
        # sample the map instead of interpolating vertex colors
        texcoord = getattr(model, "texcoord", None)
        texture = getattr(model, "texture", None)
        self._rasterize(vc, np.asarray(faces, int), np.asarray(colors),
                        ambient_weight, np.asarray(light, np.float64),
                        texcoord=None if texture is None else
                        np.asarray(texcoord, np.float64),
                        texture=texture)

    def draw_boundingbox(self, model, pose, color=(0, 1, 0)):
        """Draw the model's 3D bbox wireframe (reference :170-181)."""
        verts = np.asarray(model.vertices)
        mn, mx = verts.min(0), verts.max(0)
        corners = np.array([[x, y, z] for x in (mn[0], mx[0])
                            for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
        edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
                 (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
        pose = np.asarray(pose)
        vc = corners @ pose[:3, :3].T + pose[:3, 3]
        xy, z = project_to_pixels(vc, self.cam)
        for a, b in edges:
            self._line(xy[a], xy[b], color)

    def finish(self):
        """(rgb [H,W,3] float, depth [H,W] meters; 0 where empty)."""
        depth = np.where(np.isinf(self.depth), 0.0, self.depth)
        return self.color.copy(), depth

    # -- internals ----------------------------------------------------------

    def _splat(self, xy, z, colors):
        xi = np.round(xy[:, 0]).astype(int)
        yi = np.round(xy[:, 1]).astype(int)
        ok = (xi >= 0) & (xi < self.w) & (yi >= 0) & (yi < self.h) & (z > 0)
        for i in np.where(ok)[0]:
            if z[i] < self.depth[yi[i], xi[i]]:
                self.depth[yi[i], xi[i]] = z[i]
                self.color[yi[i], xi[i]] = colors[i][:3]

    def _line(self, p0, p1, color):
        n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) + 1)
        for t in np.linspace(0, 1, n):
            x = int(round(p0[0] + t * (p1[0] - p0[0])))
            y = int(round(p0[1] + t * (p1[1] - p0[1])))
            if 0 <= x < self.w and 0 <= y < self.h:
                self.color[y, x] = color

    def _rasterize(self, vc, faces, colors, ambient_weight, light,
                   texcoord=None, texture=None):
        xy, z = project_to_pixels(vc, self.cam)
        for f in faces:
            i0, i1, i2 = f[:3]
            if z[i0] <= 0 or z[i1] <= 0 or z[i2] <= 0:
                continue
            p0, p1, p2 = xy[i0], xy[i1], xy[i2]
            xmin = max(int(np.floor(min(p0[0], p1[0], p2[0]))), 0)
            xmax = min(int(np.ceil(max(p0[0], p1[0], p2[0]))), self.w - 1)
            ymin = max(int(np.floor(min(p0[1], p1[1], p2[1]))), 0)
            ymax = min(int(np.ceil(max(p0[1], p1[1], p2[1]))), self.h - 1)
            if xmin > xmax or ymin > ymax:
                continue
            # flat lambert shading per face
            n_vec = np.cross(vc[i1] - vc[i0], vc[i2] - vc[i0])
            nn = np.linalg.norm(n_vec)
            shade = 1.0
            if nn > 0:
                lam = abs(np.dot(n_vec / nn, light / np.linalg.norm(light)))
                shade = ambient_weight + (1 - ambient_weight) * lam
            xs, ys = np.meshgrid(np.arange(xmin, xmax + 1),
                                 np.arange(ymin, ymax + 1))
            d = ((p1[1] - p2[1]) * (p0[0] - p2[0])
                 + (p2[0] - p1[0]) * (p0[1] - p2[1]))
            if abs(d) < 1e-12:
                continue
            w0 = ((p1[1] - p2[1]) * (xs - p2[0])
                  + (p2[0] - p1[0]) * (ys - p2[1])) / d
            w1 = ((p2[1] - p0[1]) * (xs - p2[0])
                  + (p0[0] - p2[0]) * (ys - p2[1])) / d
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            # perspective-correct depth: interpolate 1/z
            zi = 1.0 / (w0 / z[i0] + w1 / z[i1] + w2 / z[i2])
            if texture is not None:
                # barycentric UV -> bilinear texture sample (GL linear
                # filtering); v runs bottom-up (GL convention) so image
                # row = (1 - v)
                u = (w0 * texcoord[i0, 0] + w1 * texcoord[i1, 0]
                     + w2 * texcoord[i2, 0])
                v = (w0 * texcoord[i0, 1] + w1 * texcoord[i1, 1]
                     + w2 * texcoord[i2, 1])
                th, tw = texture.shape[:2]
                fx = np.clip(u, 0.0, 1.0) * (tw - 1)
                fy = np.clip(1.0 - v, 0.0, 1.0) * (th - 1)
                x0i = np.clip(np.floor(fx).astype(int), 0, tw - 2)
                y0i = np.clip(np.floor(fy).astype(int), 0, th - 2)
                ax = (fx - x0i)[..., None]
                ay = (fy - y0i)[..., None]
                t00 = texture[y0i, x0i]
                t01 = texture[y0i, x0i + 1]
                t10 = texture[y0i + 1, x0i]
                t11 = texture[y0i + 1, x0i + 1]
                col = ((1 - ay) * ((1 - ax) * t00 + ax * t01)
                       + ay * ((1 - ax) * t10 + ax * t11)) * shade
            else:
                col = (w0[..., None] * colors[i0][:3]
                       + w1[..., None] * colors[i1][:3]
                       + w2[..., None] * colors[i2][:3]) * shade
            sub_d = self.depth[ymin:ymax + 1, xmin:xmax + 1]
            sub_c = self.color[ymin:ymax + 1, xmin:xmax + 1]
            upd = inside & (zi < sub_d)
            sub_d[upd] = zi[upd]
            sub_c[upd] = col[upd]


def render_depth_points(verts_cam, cam_K, img_h: int = 480,
                        img_w: int = 640, device=None):
    """Vertex-splatting z-buffer: (N,3) camera-space points -> [img_h,
    img_w] float32 depth map in the input's units (0 = empty), a tensor on
    `device` (None: the points' device when they are a tensor, else CUDA,
    which raises without a card; the CPU only when asked for).

    scatter-min replaces the reference's per-vertex Python loop
    (`annotate_keypoint.py:121-148`).  The JAX package's semantics: float32
    throughout (its x64 is off, so float64 input is cast first; `floor` in
    float64 would pick other pixels), the pixel of a point is (floor(x),
    floor(y)), kept when 0 < x < img_w, 0 < y < img_h and z > 0, and every
    other point goes to a sentinel slot past the image."""
    if device is None and torch.is_tensor(verts_cam):
        dev = verts_cam.device
    else:
        dev = resolve_device(device)
    v = torch.as_tensor(verts_cam, device=dev).float()
    k = torch.as_tensor(cam_K, device=dev).float()
    z = v[:, 2]
    x = v[:, 0] * k[0, 0] / z + k[0, 2]
    y = v[:, 1] * k[1, 1] / z + k[1, 2]
    xi = torch.floor(x).to(torch.int64)
    yi = torch.floor(y).to(torch.int64)
    ok = (xi > 0) & (xi < img_w) & (yi > 0) & (yi < img_h) & (z > 0)
    flat = torch.where(ok, yi * img_w + xi,
                       torch.full_like(xi, img_h * img_w))
    inf = torch.full_like(z, float("inf"))
    depth = torch.full((img_h * img_w + 1,), float("inf"), device=dev)
    depth.scatter_reduce_(0, flat, torch.where(ok, z, inf), reduce="amin")
    depth = depth[:-1].reshape(img_h, img_w)
    return torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
