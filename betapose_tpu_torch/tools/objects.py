"""Synthetic object zoo for the multi-object accuracy sweep.

The reference's accuracy domain is 13 *varied* real meshes — including
rotationally-symmetric (eggbox, glue) and non-convex ones — evaluated one
sequence per object with per-object weights (`betapose_evaluate.py:80`,
`KPD/src/main_fast_inference.py:29-36`; the 13-object LineMod list
{1,2,4,5,6,8..15} at `annotate_keypoint.py:63`).  The selftest's single
cube cannot falsify cube-specific tuning, so the sweep grades THIRTEEN
distinct geometries mirroring the reference protocol's variety:

- ``cube``:     the original selftest object (rich per-face colors);
- ``prism``:    180°-about-z rotationally symmetric box (paired side
  faces share colors — appearance EXACTLY invariant under the flip; the
  renderer shades by face normal only).  The eggbox analog: plain ADD is
  the wrong metric, ADD-S the right one (`utils/metrics.py:23-33`);
- ``lwedge``:   non-convex L (two boxes) — self-occluding, concave bbox;
- ``tower``:    thin elongated 5.4:1 bar (lamp/can-like slender object);
- ``tiny``:     7 cm diameter — the ADD<0.1·d bar shrinks to 7 mm (the
  ape-analog small object);
- ``ring``:     genus-1 square frame of four bars — a through-hole the
  background shows through (holepuncher/iron analog);
- ``quad``:     FOUR-fold rotational symmetry about z given as a SINGLE
  90° generator — the group-closure path: canonicalization and the
  min-over-modes loss must see all three non-identity elements;
- ``slab``:     thin flat plate, 180° symmetric about its LONG (x) axis —
  the glue analog: a flat symmetric object whose symmetry axis differs
  from the prism's;
- ``cross``:    plus-sign union of two bars — non-convex, flat;
- ``steps``:    three-box staircase — multi-part, non-convex;
- ``tbar``:     T-shape (stem + top bar);
- ``checker``:  cube with 2x2 checkered faces — the textured variant
  (within-face appearance structure, not flat face colors);
- ``dumbbell``: two end blocks joined by a thin bar — elongated with
  bulbs, mostly-empty bbox mid-section.

Symmetric-object annotation uses pose canonicalization: views that look
identical MUST get identical keypoint labels, or heatmap training
averages the symmetry modes into garbage.  ``canonicalize_pose`` picks a
deterministic representative of the symmetry orbit (standard practice for
keypoint training on symmetric objects); the EVAL still compares against
the raw GT pose, which is exactly why the symmetric object fails plain
ADD and passes ADD-S end-to-end.

``MeshObject`` closes the provided symmetry generators into the full
finite group at construction (minus identity), so an object specified by
a single generator of a 4-fold symmetry (``quad``) canonicalizes and
trains with every mode — not just the generator.

A copy of the JAX package's `tools/objects.py` (numpy), which the port
does not import.
"""

from __future__ import annotations

import numpy as np

# face order: x-, x+, y-, y+, z-, z+  (corner index = 4*(x>0)+2*(y>0)+(z>0))
_QUADS = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
          (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]


def _box_mesh(center, half, face_colors):
    """Axis-aligned box triangle mesh with per-face colors.

    face_colors is [6,3] (flat per-face color), [6,2,3] (2x2 checker of
    two alternating colors per face: sub-cell (i,j) gets color (i+j)%2) or
    [6,4,3] (2x2 grid of four DISTINCT colors per face: sub-cell (i,j)
    gets color 2*i+j).

    The [6,2,3] diagonal checker is appearance-degenerate: every face maps
    onto itself under a 180° in-plane rotation, so near-frontal views of a
    face have a near-identical twin with keypoint labels an object-extent
    apart — the DESIGN.md §6b canonicalization-seam failure without an
    exact symmetry to hang min-over-modes supervision on (measured: KPD
    PCK collapses to 0.03 where the identically-shaped flat-color cube
    reaches 0.97).  The [6,4,3] grid keeps within-face appearance
    structure while every in-plane rotation changes the image.

    Returns (verts, colors, tris) — same quad corner/winding layout as
    the selftest CubeModel."""
    center = np.asarray(center, float)
    half = np.asarray(half, float)
    c = center + np.array([[x, y, z] for x in (-half[0], half[0])
                           for y in (-half[1], half[1])
                           for z in (-half[2], half[2])])
    face_colors = np.asarray(face_colors, float)
    checker = face_colors.ndim == 3
    verts, cols, tris = [], [], []

    def emit_quad(p, col):
        base = len(verts)
        verts.extend(p)
        cols.extend([col] * 4)
        tris.append([base, base + 1, base + 2])
        tris.append([base, base + 2, base + 3])

    for qi, q in enumerate(_QUADS):
        p = [c[vi] for vi in q]
        if not checker:
            emit_quad(p, face_colors[qi])
            continue
        # bilinear 2x2 subdivision; sub-cell (i,j) gets color (i+j)%2
        # (2-color checker) or 2*i+j (4-color grid)
        def at(u, v):
            return ((1 - u) * (1 - v) * p[0] + u * (1 - v) * p[1]
                    + u * v * p[2] + (1 - u) * v * p[3])
        n_cell_colors = face_colors.shape[1]
        for i in range(2):
            for j in range(2):
                u0, u1 = i * 0.5, (i + 1) * 0.5
                v0, v1 = j * 0.5, (j + 1) * 0.5
                sub = [at(u0, v0), at(u1, v0), at(u1, v1), at(u0, v1)]
                ci = (i + j) % 2 if n_cell_colors == 2 else 2 * i + j
                emit_quad(sub, face_colors[qi][ci])
    return np.asarray(verts), np.asarray(cols), np.asarray(tris, int)


class MeshObject:
    """Renderable object (.vertices/.colors/.faces for geometry.Renderer)
    with designated keypoints, symmetry group, and metric metadata."""

    def __init__(self, name, boxes, n_kp=26, symmetries=()):
        """boxes: list of (center, half, face_colors[6])."""
        self.name = name
        self.boxes = [(np.asarray(c, float), np.asarray(h, float))
                      for c, h, _ in boxes]
        vs, cs, ts = [], [], []
        off = 0
        for c, h, fc in boxes:
            v, col, t = _box_mesh(c, h, fc)
            vs.append(v)
            cs.append(col)
            ts.append(t + off)
            off += len(v)
        self.vertices = np.concatenate(vs)
        self.colors = np.concatenate(cs)
        self.faces = np.concatenate(ts)
        # symmetries: GENERATORS of the object-frame symmetry group (3x3
        # rotations, identity excluded); () = asymmetric.  The generators
        # are closed into the full finite group here, so downstream
        # consumers (canonicalize_pose, symmetry_keypoint_perms, the
        # min-over-modes loss) always see every non-identity element —
        # a 4-fold object specified by one 90° generator trains and
        # canonicalizes with all three modes, not just the generator.
        if symmetries:
            group = _symmetry_group(symmetries)
            self.symmetries = tuple(
                G for G in group if not np.allclose(G, np.eye(3),
                                                    atol=1e-9))
        else:
            self.symmetries = ()
        self.keypoints = designate_keypoints(self, n_kp)
        # channel permutations induced by each symmetry element (orbit-
        # closed designation guarantees they exist) — consumed by the
        # symmetry-aware KPD training loss
        self.symmetry_perms = (symmetry_keypoint_perms(
            self.keypoints, self.symmetries) if self.symmetries else ())
        d = self.vertices
        self.diameter = float(np.sqrt(
            ((d[None] - d[:, None]) ** 2).sum(-1)).max())

    def contains_interior(self, p, eps=1e-9):
        """True if p lies strictly inside any constituent box."""
        for c, h in self.boxes:
            if np.all(np.abs(p - c) < h - eps):
                return True
        return False


def _box_candidates(center, half):
    """Corner / face-center / edge-midpoint candidate keypoints of one box
    (the same well-spread designation scheme the cube selftest uses — what
    a 3D-SIFT designator produces on a faceted solid)."""
    center = np.asarray(center, float)
    hx, hy, hz = np.asarray(half, float)
    corners = center + np.array([[x, y, z] for x in (-hx, hx)
                                 for y in (-hy, hy) for z in (-hz, hz)])
    centers = center + np.array([[-hx, 0, 0], [hx, 0, 0], [0, -hy, 0],
                                 [0, hy, 0], [0, 0, -hz], [0, 0, hz]])
    edge_mids = []
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(np.abs(corners[i] - corners[j]) > 1e-9) == 1:
                edge_mids.append((corners[i] + corners[j]) / 2)
    return np.concatenate([corners, centers, np.asarray(edge_mids)])


def designate_keypoints(obj: MeshObject, n_kp: int) -> np.ndarray:
    """Designate n_kp well-spread surface keypoints: pool the per-box
    corner/center/edge-mid candidates, drop points swallowed inside the
    union (a box-A face center can sit inside box B), then greedy
    farthest-point selection for spread (the min-distance spirit of
    `Model3D.refine`, `utils/model.py:29-48`, run forward instead of
    backward).

    For symmetric objects the selection is ORBIT-closed: candidates are
    grouped into orbits under the symmetry group and whole orbits are
    selected, so the designated set maps onto itself under every symmetry
    element.  That closure is what makes the symmetry's action on
    keypoints a channel PERMUTATION (`symmetry_keypoint_perms`) — the
    property the symmetry-aware training loss needs."""
    cands = np.concatenate([_box_candidates(c, h) for c, h in obj.boxes])
    keep = np.array([not obj.contains_interior(p) for p in cands])
    cands = cands[keep]
    # dedupe (shared edges/corners between boxes)
    _, uniq = np.unique(np.round(cands, 9), axis=0, return_index=True)
    cands = cands[np.sort(uniq)]
    if len(cands) <= n_kp:
        return cands
    if obj.symmetries:
        return _designate_orbit_closed(cands, obj.symmetries, n_kp)
    # farthest-point: seed with the point farthest from the centroid
    sel = [int(np.argmax(((cands - cands.mean(0)) ** 2).sum(1)))]
    d2 = ((cands - cands[sel[0]]) ** 2).sum(1)
    for _ in range(n_kp - 1):
        nxt = int(np.argmax(d2))
        sel.append(nxt)
        d2 = np.minimum(d2, ((cands - cands[nxt]) ** 2).sum(1))
    return cands[np.asarray(sel)]


def _symmetry_group(symmetries, tol=1e-9):
    """Close the generator set into the full (finite) symmetry group,
    identity included."""
    group = [np.eye(3)]
    frontier = [np.asarray(S, float) for S in symmetries]
    while frontier:
        S = frontier.pop()
        if any(np.allclose(S, G, atol=tol) for G in group):
            continue
        group.append(S)
        for G in list(group):
            frontier.append(S @ G)
            frontier.append(G @ S)
        if len(group) > 64:
            raise ValueError("symmetry group closure exceeded 64 elements")
    return group


def _candidate_orbits(cands, symmetries, tol=1e-6):
    """Partition candidate indices into orbits under the symmetry group.
    Every group image of a candidate must land on a candidate (the pooled
    corner/center/edge-mid set of a symmetric solid is closed by
    construction)."""
    group = _symmetry_group(symmetries)
    assigned = np.full(len(cands), -1, int)
    orbits = []
    for i in range(len(cands)):
        if assigned[i] >= 0:
            continue
        orb = set()
        for G in group:
            p = G @ cands[i]
            d2 = ((cands - p) ** 2).sum(1)
            j = int(np.argmin(d2))
            if d2[j] > tol * tol:
                raise ValueError(
                    "candidate set is not closed under the symmetry group")
            orb.add(j)
        oid = len(orbits)
        for j in orb:
            assigned[j] = oid
        orbits.append(sorted(orb))
    return orbits


def _designate_orbit_closed(cands, symmetries, n_kp):
    """Greedy farthest-point over symmetry ORBITS: each step adds the
    whole orbit whose best member is farthest from the selected set,
    skipping orbits that would make the remaining budget unfillable
    (subset-sum feasibility over the remaining orbit sizes)."""
    orbits = _candidate_orbits(cands, symmetries)

    def fillable(budget, sizes):
        ok = np.zeros(budget + 1, bool)
        ok[0] = True
        for s in sizes:
            if s <= budget:
                ok[s:] |= ok[:-s].copy()
        return bool(ok[budget])

    if not fillable(n_kp, [len(o) for o in orbits]):
        raise ValueError(
            f"n_kp={n_kp} cannot be met with symmetry-closed orbits "
            f"(orbit sizes: {sorted(len(o) for o in orbits)})")
    remaining = list(range(len(orbits)))
    sel = []
    d2 = ((cands - cands.mean(0)) ** 2).sum(1)   # seed score: centroid dist
    while len(sel) < n_kp and remaining:
        budget = n_kp - len(sel)
        best_oi, best_score = None, -1.0
        for oi in remaining:
            orb = orbits[oi]
            if len(orb) > budget:
                continue
            rest = [len(orbits[oj]) for oj in remaining
                    if oj != oi]
            if not fillable(budget - len(orb), rest):
                continue
            score = float(d2[orb].max())
            if score > best_score:
                best_oi, best_score = oi, score
        if best_oi is None:
            break
        remaining.remove(best_oi)
        for j in orbits[best_oi]:
            sel.append(j)
            d2 = np.minimum(d2, ((cands - cands[j]) ** 2).sum(1))
    assert len(sel) == n_kp
    return cands[np.asarray(sel)]


def symmetry_keypoint_perms(keypoints, symmetries, tol=1e-6):
    """Per symmetry element S, the permutation pi with
    S @ keypoints[i] == keypoints[pi[i]].

    This is the bridge between pose symmetry and heatmap channels: the
    keypoint label set for pose R.S equals the label set for pose R with
    channels permuted by pi (visibility included — keypoint i under R.S
    projects exactly where keypoint pi[i] does under R).  The KPD
    symmetry-aware loss (`kpd_train.make_loss_fn(sym_perms=...)`) uses it
    to score a prediction against every mode and train on the best one."""
    keypoints = np.asarray(keypoints, float)
    perms = []
    for S in symmetries:
        mapped = keypoints @ np.asarray(S, float).T
        d2 = ((mapped[:, None] - keypoints[None]) ** 2).sum(-1)
        perm = np.argmin(d2, axis=1)
        worst = float(np.sqrt(d2[np.arange(len(perm)), perm]).max())
        if worst > tol or len(set(perm.tolist())) != len(perm):
            raise ValueError(
                f"keypoint set is not closed under symmetry "
                f"(worst match {worst:.2e})")
        perms.append(perm.astype(np.int32))
    return tuple(perms)


def canonicalize_pose(pose: np.ndarray, symmetries) -> np.ndarray:
    """Deterministic representative of the pose's symmetry orbit.

    Among {R} ∪ {R·S : S in symmetries}, pick the rotation whose
    row-major flattening is lexicographically largest (measure-zero tie
    set).  Identical-looking views of a symmetric object therefore get
    identical keypoint annotations — the supervision stays consistent and
    the trained net predicts THIS representative, which differs from the
    raw GT by a symmetry element on ~half the frames (2-fold case): the
    e2e demonstration that plain ADD rejects and ADD-S accepts."""
    pose = np.asarray(pose)
    if not symmetries:
        return pose
    R = pose[:3, :3]
    best_R, best_key = R, tuple(np.round(R.reshape(-1), 9))
    for S in symmetries:
        Rc = R @ np.asarray(S)
        key = tuple(np.round(Rc.reshape(-1), 9))
        if key > best_key:
            best_R, best_key = Rc, key
    out = pose.copy()
    out[:3, :3] = best_R
    return out


# bright, saturated, mutually distinct palettes (background noise is dim)
def cube_object(n_kp: int = 26) -> MeshObject:
    colors = np.array([
        [0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.3, 0.9],
        [0.9, 0.9, 0.2], [0.9, 0.3, 0.9], [0.2, 0.9, 0.9]])
    return MeshObject("cube", [((0, 0, 0), (0.04, 0.04, 0.04), colors)],
                      n_kp=n_kp)


def prism_object(n_kp: int = 26) -> MeshObject:
    """180°-about-z symmetric rectangular prism: ±x faces share red, ±y
    faces share green; distinct flat caps (blue / yellow) kill any OTHER
    symmetry (no 4-fold — cross-section is rectangular, hx != hy — and no
    cap swap)."""
    red, green = [0.95, 0.25, 0.2], [0.2, 0.9, 0.3]
    blue, yellow = [0.25, 0.35, 0.95], [0.95, 0.9, 0.2]
    colors = np.array([red, red, green, green, blue, yellow])
    return MeshObject(
        "prism", [((0, 0, 0), (0.025, 0.04, 0.05), colors)], n_kp=n_kp,
        symmetries=(np.diag([-1.0, -1.0, 1.0]),))


def lwedge_object(n_kp: int = 26) -> MeshObject:
    """Non-convex L: a tall bar plus a foot jutting out in +y at the
    bottom — concave silhouette, parts that self-occlude, a bbox whose
    interior is mostly empty."""
    bar_colors = np.array([
        [0.95, 0.3, 0.2], [0.2, 0.85, 0.35], [0.25, 0.4, 0.95],
        [0.95, 0.85, 0.2], [0.9, 0.3, 0.9], [0.2, 0.9, 0.9]])
    foot_colors = np.array([
        [0.95, 0.55, 0.15], [0.55, 0.25, 0.9], [0.35, 0.95, 0.65],
        [0.95, 0.4, 0.55], [0.6, 0.8, 0.2], [0.9, 0.7, 0.5]])
    return MeshObject(
        "lwedge",
        [((0, 0, 0), (0.02, 0.02, 0.05), bar_colors),
         ((0, 0.04, -0.03), (0.02, 0.035, 0.02), foot_colors)],
        n_kp=n_kp)


def tower_object(n_kp: int = 26) -> MeshObject:
    """Thin elongated 5.4:1 bar — the slender-object class (the per-view
    silhouette is ~25 px wide at the sweep's working distance)."""
    colors = np.array([
        [0.9, 0.25, 0.25], [0.25, 0.85, 0.3], [0.3, 0.4, 0.95],
        [0.95, 0.85, 0.2], [0.85, 0.3, 0.9], [0.25, 0.9, 0.85]])
    return MeshObject("tower",
                      [((0, 0, 0), (0.012, 0.012, 0.065), colors)],
                      n_kp=n_kp)


def tiny_object(n_kp: int = 26) -> MeshObject:
    """Small-diameter object (~7 cm): the ADD < 0.1·diameter bar shrinks
    to 7 mm — the ape-analog hardness class."""
    colors = np.array([
        [0.95, 0.45, 0.7], [0.45, 0.95, 0.45], [0.5, 0.6, 0.95],
        [0.95, 0.7, 0.25], [0.7, 0.35, 0.95], [0.4, 0.95, 0.85]])
    return MeshObject("tiny",
                      [((0, 0, 0), (0.018, 0.022, 0.02), colors)],
                      n_kp=n_kp)


def ring_object(n_kp: int = 26) -> MeshObject:
    """Genus-1 square frame: four bars around a 7x7 cm through-hole the
    background shows through — the holed-object class.  The side bars'
    z-half is 0.0002 under the top/bottom bars' so overlapping corner
    faces never z-fight."""
    def pal(base):
        base = np.asarray(base)
        return np.clip(np.stack([base * s for s in
                                 (1.0, 0.75, 0.9, 0.65, 0.85, 0.7)]), 0, 1)
    top = pal([0.95, 0.3, 0.25])
    bot = pal([0.3, 0.9, 0.35])
    left = pal([0.35, 0.45, 0.95])
    right = pal([0.95, 0.85, 0.25])
    return MeshObject("ring", [
        ((0, 0.0425, 0), (0.05, 0.0075, 0.015), top),
        ((0, -0.0425, 0), (0.05, 0.0075, 0.015), bot),
        ((-0.0425, 0, 0), (0.0075, 0.05, 0.0148), left),
        ((0.0425, 0, 0), (0.0075, 0.05, 0.0148), right)], n_kp=n_kp)


def quad_object(n_kp: int = 26) -> MeshObject:
    """4-fold rotationally symmetric about z: square cross-section, all
    four side faces one color, distinct caps.  The symmetry is given as a
    SINGLE 90° generator — MeshObject closes it into {90°,180°,270°}, so
    canonicalization and the min-over-modes loss act on the full group."""
    side = [0.95, 0.55, 0.15]
    blue, green = [0.25, 0.35, 0.95], [0.25, 0.9, 0.35]
    colors = np.array([side, side, side, side, blue, green])
    rot90 = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return MeshObject("quad",
                      [((0, 0, 0), (0.03, 0.03, 0.055), colors)],
                      n_kp=n_kp, symmetries=(rot90,))


def slab_object(n_kp: int = 26) -> MeshObject:
    """Thin flat plate, 180° rotationally symmetric about its LONG (x)
    axis: ±y faces share a color, ±z faces share a color, the two x caps
    are distinct (killing any further symmetry).  The glue analog — a
    flat symmetric object whose symmetry axis differs from the prism's
    z-flip."""
    red, cyan = [0.95, 0.3, 0.25], [0.25, 0.9, 0.85]
    green, violet = [0.3, 0.9, 0.35], [0.7, 0.35, 0.95]
    colors = np.array([red, cyan, green, green, violet, violet])
    return MeshObject("slab",
                      [((0, 0, 0), (0.055, 0.035, 0.009), colors)],
                      n_kp=n_kp, symmetries=(np.diag([1.0, -1.0, -1.0]),))


def cross_object(n_kp: int = 26) -> MeshObject:
    """Plus-sign union of two crossing bars — non-convex, flat.  All
    twelve faces distinctly colored, so the 2-fold geometric symmetry of
    the cross is broken by appearance (asymmetric for training)."""
    bar_a = np.array([
        [0.95, 0.3, 0.25], [0.3, 0.9, 0.35], [0.3, 0.45, 0.95],
        [0.95, 0.85, 0.25], [0.85, 0.3, 0.9], [0.3, 0.9, 0.85]])
    bar_b = np.array([
        [0.95, 0.55, 0.2], [0.55, 0.3, 0.9], [0.4, 0.95, 0.6],
        [0.95, 0.4, 0.55], [0.6, 0.8, 0.25], [0.9, 0.7, 0.45]])
    return MeshObject("cross", [
        ((0, 0, 0), (0.055, 0.016, 0.013), bar_a),
        ((0, 0, 0), (0.016, 0.055, 0.013), bar_b)], n_kp=n_kp)


def steps_object(n_kp: int = 26) -> MeshObject:
    """Three-box staircase rising along y — multi-part, non-convex,
    strongly orientation-revealing."""
    def pal(base):
        base = np.asarray(base)
        return np.clip(np.stack([base * s for s in
                                 (1.0, 0.7, 0.9, 0.6, 0.8, 0.65)]), 0, 1)
    return MeshObject("steps", [
        ((0, -0.027, -0.0225), (0.022, 0.0135, 0.0075),
         pal([0.95, 0.3, 0.3])),
        ((0, 0.0, -0.0075), (0.022, 0.0135, 0.0225),
         pal([0.3, 0.9, 0.4])),
        ((0, 0.027, 0.0075), (0.022, 0.0135, 0.0375),
         pal([0.35, 0.5, 0.95]))], n_kp=n_kp)


def tbar_object(n_kp: int = 26) -> MeshObject:
    """T-shape: vertical stem + horizontal top bar (the bar swallows the
    stem's top face — interior candidates are pruned)."""
    stem = np.array([
        [0.95, 0.35, 0.3], [0.35, 0.9, 0.4], [0.35, 0.5, 0.95],
        [0.95, 0.85, 0.3], [0.85, 0.35, 0.9], [0.35, 0.9, 0.85]])
    bar = np.array([
        [0.95, 0.6, 0.2], [0.6, 0.35, 0.95], [0.45, 0.95, 0.65],
        [0.95, 0.45, 0.6], [0.65, 0.85, 0.3], [0.9, 0.75, 0.5]])
    return MeshObject("tbar", [
        ((0, 0, -0.02), (0.014, 0.014, 0.04), stem),
        ((0, 0, 0.028), (0.05, 0.016, 0.012), bar)], n_kp=n_kp)


def checker_object(n_kp: int = 26) -> MeshObject:
    """Textured variant: a cube whose faces carry a 2x2 grid of four
    DISTINCT colors — within-face appearance structure instead of the
    zoo's flat face colors (the closest box-world analog of the
    reference's textured meshes, `utils/renderer.py:50-85` textured
    program).

    History: the first revision used a 2-color diagonal checker per face.
    That texture is invariant under a 180° in-plane rotation of every
    face, so near-frontal views have near-identical twins with keypoint
    labels an object-extent apart — mode-averaged supervision collapsed
    KPD to PCK 0.03 (see _box_mesh docstring; the measured failure is
    recorded in PARITY.md).  Real textured meshes (LineMod benchvise/
    iron/phone) are locally distinctive; the 4-color grid restores that
    property while keeping the within-face structure this row exists to
    exercise."""
    quads = np.array([
        [[0.95, 0.25, 0.25], [0.25, 0.25, 0.3],
         [0.95, 0.85, 0.25], [0.3, 0.6, 0.3]],
        [[0.25, 0.9, 0.3], [0.95, 0.95, 0.9],
         [0.2, 0.3, 0.7], [0.85, 0.5, 0.2]],
        [[0.3, 0.4, 0.95], [0.95, 0.85, 0.25],
         [0.8, 0.25, 0.45], [0.35, 0.8, 0.8]],
        [[0.9, 0.3, 0.9], [0.3, 0.9, 0.85],
         [0.9, 0.65, 0.3], [0.25, 0.4, 0.55]],
        [[0.95, 0.6, 0.2], [0.3, 0.3, 0.9],
         [0.55, 0.9, 0.35], [0.85, 0.3, 0.6]],
        [[0.6, 0.95, 0.4], [0.8, 0.25, 0.5],
         [0.3, 0.55, 0.95], [0.9, 0.9, 0.35]]])
    return MeshObject("checker",
                      [((0, 0, 0), (0.035, 0.035, 0.035), quads)],
                      n_kp=n_kp)


def dumbbell_object(n_kp: int = 26) -> MeshObject:
    """Two end blocks joined by a thin bar (the bar overlaps the ends by
    3 mm so its cap candidates fall strictly inside and are pruned) —
    elongated with bulbs, a mostly-empty bbox mid-section."""
    end_a = np.array([
        [0.95, 0.3, 0.25], [0.3, 0.9, 0.35], [0.3, 0.45, 0.95],
        [0.95, 0.85, 0.25], [0.85, 0.3, 0.9], [0.3, 0.9, 0.85]])
    end_b = np.array([
        [0.95, 0.55, 0.2], [0.55, 0.3, 0.9], [0.4, 0.95, 0.6],
        [0.95, 0.4, 0.55], [0.6, 0.8, 0.25], [0.9, 0.7, 0.45]])
    bar = np.array([[0.8, 0.8, 0.3]] * 6)
    return MeshObject("dumbbell", [
        ((0, 0, -0.042), (0.02, 0.02, 0.02), end_a),
        ((0, 0, 0), (0.009, 0.009, 0.025), bar),
        ((0, 0, 0.042), (0.02, 0.02, 0.02), end_b)], n_kp=n_kp)


# the 13-object sweep roster (mirrors the reference's 13-object LineMod
# protocol breadth, `annotate_keypoint.py:63`): three symmetric rows
# (prism 2-fold, quad 4-fold, slab flat 2-fold-about-x), four non-convex
# (lwedge/cross/steps/tbar), thin (tower), small (tiny), holed (ring),
# textured (checker), bulbed-elongated (dumbbell)
OBJECT_BUILDERS = {
    "cube": cube_object,
    "prism": prism_object,
    "lwedge": lwedge_object,
    "tower": tower_object,
    "tiny": tiny_object,
    "ring": ring_object,
    "quad": quad_object,
    "slab": slab_object,
    "cross": cross_object,
    "steps": steps_object,
    "tbar": tbar_object,
    "checker": checker_object,
    "dumbbell": dumbbell_object,
}
