"""PLY point-cloud / mesh IO (no external deps).

Supports ASCII and binary_little_endian PLY, the two encodings used by the
LineMod/SIXD model meshes and the designated-keypoint files (reference:
`utils/model.py:79-85` reads x/y/z via plyfile; `1_keypoint_designator`
writes ASCII keypoint clouds; `utils/utils.py:446` writes ASCII ply).
"""

from __future__ import annotations

import dataclasses
import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class PlyElement:
    name: str
    count: int
    # list of (prop_name, np_dtype_str) for scalar props;
    # list props are (name, (count_dtype, item_dtype))
    properties: list
    data: dict  # prop name -> np.ndarray (object array for list props)


@dataclasses.dataclass
class PlyFile:
    elements: dict  # name -> PlyElement
    fmt: str  # 'ascii' | 'binary_little_endian'

    def __getitem__(self, name):
        return self.elements[name]


def read_ply(path) -> PlyFile:
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0]
            if key == b"format":
                fmt = tokens[1].decode()
            elif key == b"comment" or key == b"obj_info":
                continue
            elif key == b"element":
                cur = PlyElement(tokens[1].decode(), int(tokens[2]), [], {})
                elements.append(cur)
            elif key == b"property":
                if tokens[1] == b"list":
                    cdt = _PLY_TO_NP[tokens[2].decode()]
                    idt = _PLY_TO_NP[tokens[3].decode()]
                    cur.properties.append((tokens[4].decode(), (cdt, idt)))
                else:
                    cur.properties.append(
                        (tokens[2].decode(), _PLY_TO_NP[tokens[1].decode()]))
            elif key == b"end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        for el in elements:
            if fmt == "ascii":
                _read_ascii_element(f, el)
            else:
                _read_binary_element(f, el)

    return PlyFile({el.name: el for el in elements}, fmt)


def _read_ascii_element(f, el: PlyElement):
    has_list = any(isinstance(dt, tuple) for _, dt in el.properties)
    rows = []
    for _ in range(el.count):
        rows.append(f.readline().split())
    if not has_list:
        arr = np.array(rows, dtype=np.float64) if rows else np.zeros(
            (0, len(el.properties)))
        for i, (name, dt) in enumerate(el.properties):
            el.data[name] = arr[:, i].astype(dt)
    else:
        for name, dt in el.properties:
            el.data[name] = np.empty(el.count, dtype=object)
        for r, row in enumerate(rows):
            pos = 0
            for name, dt in el.properties:
                if isinstance(dt, tuple):
                    n = int(row[pos]); pos += 1
                    el.data[name][r] = np.array(
                        row[pos:pos + n], dtype=dt[1])
                    pos += n
                else:
                    el.data[name][r] = np.array(row[pos], dtype=dt)
                    pos += 1


def _read_binary_element(f, el: PlyElement):
    has_list = any(isinstance(dt, tuple) for _, dt in el.properties)
    if not has_list:
        dtype = np.dtype([(name, "<" + dt) for name, dt in el.properties])
        raw = np.frombuffer(f.read(dtype.itemsize * el.count), dtype=dtype,
                            count=el.count)
        for name, _ in el.properties:
            el.data[name] = np.ascontiguousarray(raw[name])
    else:
        for name, dt in el.properties:
            el.data[name] = np.empty(el.count, dtype=object)
        for r in range(el.count):
            for name, dt in el.properties:
                if isinstance(dt, tuple):
                    cdt = np.dtype("<" + dt[0])
                    n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                    idt = np.dtype("<" + dt[1])
                    el.data[name][r] = np.frombuffer(
                        f.read(idt.itemsize * n), idt, count=n).copy()
                else:
                    d = np.dtype("<" + dt)
                    el.data[name][r] = np.frombuffer(f.read(d.itemsize), d)[0]


def read_vertices(path) -> np.ndarray:
    """Load the (N, 3) float64 x/y/z vertex array from a PLY file."""
    ply = read_ply(path)
    v = ply["vertex"]
    return np.stack([v.data["x"], v.data["y"], v.data["z"]],
                    axis=1).astype(np.float64)


def read_mesh(path):
    """Return (vertices (N,3) f64, faces (M,3) int32 or None)."""
    ply = read_ply(path)
    verts = read_vertices(path)
    faces = None
    if "face" in ply.elements:
        fel = ply["face"]
        for key in ("vertex_indices", "vertex_index"):
            if key in fel.data:
                faces = np.stack(fel.data[key]).astype(np.int32)
                break
    return verts, faces


def write_vertices_ascii(path, vertices: np.ndarray, comment: str = ""):
    """Write an (N,3) point cloud as ASCII ply (the designator output format,
    reference `1_keypoint_designator/main.cpp:88`)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        if comment:
            f.write(f"comment {comment}\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")


def read_texcoords(path):
    """Texture coordinates from a PLY, per the conventions the reference
    renderer consumes (`utils/model.py:106-129`): vertex-wise
    `texture_u`/`texture_v` properties, or a face-wise `texcoord` list
    property scattered to per-vertex slots (last write wins, exactly the
    reference's `temp[indices.flatten()] = texcoord.reshape(-1, 2)`).
    Returns (N, 2) float64 or None."""
    ply = read_ply(path)
    v = ply["vertex"]
    if "texture_u" in v.data and "texture_v" in v.data:
        return np.stack([v.data["texture_u"], v.data["texture_v"]],
                        axis=1).astype(np.float64)
    if "face" in ply.elements and "texcoord" in ply["face"].data:
        fel = ply["face"]
        tc_face = np.stack(fel.data["texcoord"]).astype(np.float64)
        idx = None
        for key in ("vertex_indices", "vertex_index"):
            if key in fel.data:
                idx = np.stack(fel.data[key]).astype(np.int64)
                break
        if idx is None:
            return None
        out = np.zeros((v.count, 2))
        out[idx.reshape(-1)] = tc_face.reshape(-1, 2)
        return out
    return None
