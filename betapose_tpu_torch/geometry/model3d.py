"""3D object / keypoint model container.

Re-implementation of the reference `utils/model.py` Model3D: PLY loading with
unit scaling (`utils/model.py:79-85`) and the greedy min-distance keypoint
pruning `refine` (`utils/model.py:29-48`).  The reference refine is an O(N^3)
triple Python loop; here each deletion step is a vectorized O(N^2) argmin over
the pairwise-distance matrix with identical tie-breaking (numpy argmin returns
the first occurrence in row-major scan order, matching the reference's
`i`-then-`j` scan with strict `<`).
"""

from __future__ import annotations

import numpy as np

from betapose_tpu_torch.data import ply as plyio


class Model3D:
    def __init__(self, file_to_load=None, scale: float = 1.0):
        self.vertices: np.ndarray | None = None
        self.faces = None
        self.diameter: float | None = None
        self.texcoord: np.ndarray | None = None   # (N,2) UV, v up
        self.texture: np.ndarray | None = None    # (H,W,3) float [0,1]
        if file_to_load:
            self.load(file_to_load, scale=scale)

    def load(self, path, demean: bool = False, scale: float = 1.0):
        self.vertices, self.faces = plyio.read_mesh(path)
        self.vertices = self.vertices * scale
        if demean:
            self.vertices = self.vertices - self.vertices.mean(axis=0)
        self._load_texture(path)
        return self

    def _load_texture(self, path):
        """Texture map lookup next to the mesh (same stem, .png/.jpg) +
        PLY texcoords — the reference's textured-model convention
        (`utils/model.py:97-129`, consumed by the renderer's textured
        program `utils/renderer.py:50-85`).  Missing either piece leaves
        the model vertex-colored/untextured; never an error."""
        import os
        stem = os.path.splitext(path)[0]
        tex_path = next((stem + ext for ext in (".png", ".jpg", ".jpeg")
                         if os.path.exists(stem + ext)), None)
        if tex_path is None:
            return
        try:
            tc = plyio.read_texcoords(path)
        except Exception:
            tc = None
        if tc is None:
            return
        import cv2
        img = cv2.imread(tex_path, cv2.IMREAD_COLOR)
        if img is None:
            return
        self.texture = (cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                        .astype(np.float64) / 255.0)
        self.texcoord = tc

    def refine(self, total_kp: int = 30, save: bool = False,
               save_path: str = "test.ply"):
        """Greedily delete the first member of the current closest pair until
        only `total_kp` vertices remain (parity with `utils/model.py:29-48`)."""
        v = np.asarray(self.vertices, dtype=np.float64)
        n = len(v)
        if n <= total_kp:
            return self
        # Pairwise squared distances; refresh after each deletion.
        for _ in range(n - total_kp):
            diff = v[:, None, :] - v[None, :, :]
            d = np.sqrt(np.einsum("ijk,ijk->ij", diff, diff))
            np.fill_diagonal(d, np.inf)
            # Reference scans i (rows) then j (cols) keeping strict '<', i.e.
            # first occurrence of the minimum in row-major order, and deletes
            # the row index of that pair.
            flat = np.argmin(d)
            min_index = flat // d.shape[1]
            v = np.delete(v, min_index, axis=0)
        self.vertices = v
        if save:
            plyio.write_vertices_ascii(save_path, v)
        return self

    def bbox_corners(self) -> np.ndarray:
        """8 axis-aligned bounding-box corners (reference `_compute_bbox`)."""
        v = self.vertices
        mn, mx = v.min(axis=0), v.max(axis=0)
        corners = []
        for x in (mn[0], mx[0]):
            for y in (mn[1], mx[1]):
                for z in (mn[2], mx[2]):
                    corners.append([x, y, z])
        # Reference ordering: (minx,miny,minz),(minx,maxy,minz),(minx,miny,maxz),
        # (minx,maxy,maxz),(maxx,miny,minz),(maxx,maxy,minz),(maxx,miny,maxz),
        # (maxx,maxy,maxz)
        order = [0, 2, 1, 3, 4, 6, 5, 7]
        return np.asarray(corners, dtype=np.float32)[order]
