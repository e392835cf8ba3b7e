"""The device mesh and the sharding helpers.

Counterpart of `betapose_tpu/parallel/mesh.py`.  The mesh spans every rank
of the process group (`launch.run_ranks`), with the JAX mesh's axes in its
order: `data`, then `space` when spatial_parallel > 1, then `model` when
model_parallel > 1.  Rank r sits where JAX puts device r (row-major over
the axes), so rank r's shards are JAX's shards on device r.

Where JAX places a global array with a sharding and lets XLA move it,
here each rank holds the global value (SPMD: every rank is called with
the same arguments) and keeps its own part:
- `replicate`: tensors and modules broadcast from rank 0;
- `shard_batch`: the rank's rows of the leading axis on `data`;
- `shard_frames`: rows on `data` and image rows (axis 1) on `space`;
- `shard_params_tp`: the JAX leaf rule in torch layout, below.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from betapose_tpu_torch.parallel.collectives import GroupRef


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              spatial_parallel: int = 1, device_type: str | None = None
              ) -> DeviceMesh:
    """The ('data'[, 'space'][, 'model']) mesh over the process group's
    ranks.  n_devices, when given, must be the world size (a mesh here
    spans every rank); model_parallel * spatial_parallel must divide it,
    as JAX's `make_mesh` asserts."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the "
                         f"process group has {world}")
    inner = model_parallel * spatial_parallel
    if n % inner:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel} x spatial_parallel="
                         f"{spatial_parallel}")
    axes = [("data", n // inner)]
    if spatial_parallel > 1:
        axes.append(("space", spatial_parallel))
    if model_parallel > 1:
        axes.append(("model", model_parallel))
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(s for _, s in axes),
                            mesh_dim_names=tuple(a for a, _ in axes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of `axis`, 1 when the mesh has no such axis."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on `axis`, 0 when the mesh has no such axis."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of `axis` (a `collectives.GroupRef`), None when
    the mesh has no such axis (nothing to reduce over)."""
    if axis not in mesh.mesh_dim_names:
        return None
    return GroupRef(mesh.get_group(axis))


def band(n: int, parts: int, i: int) -> tuple[int, int]:
    """Rows [lo, hi) of part i when n rows split into `parts` contiguous
    bands, the first n % parts one row longer (`torch.tensor_split`)."""
    q, r = divmod(n, parts)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's rows of every array (numpy or tensor) of `tree`, the
    leading axis split over `data`.  The axis must divide evenly."""
    d, i = axis_size(mesh, "data"), axis_index(mesh, "data")

    def take(x):
        if x.shape[0] % d:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{d} data ranks")
        b = x.shape[0] // d
        return x[i * b:(i + 1) * b]

    return _map(tree, take)


def shard_frames(mesh: DeviceMesh, frames):
    """This rank's part of frames [B, H, W, C]: its rows on `data` and its
    image rows (`band`) on `space`."""
    frames = shard_batch(mesh, frames)
    s = axis_size(mesh, "space")
    if s == 1:
        return frames
    lo, hi = band(frames.shape[1], s, axis_index(mesh, "space"))
    return frames[:, lo:hi]


def replicate(mesh: DeviceMesh, tree):
    """Every rank gets rank 0's values: the tensors of `tree` (or the
    parameters and buffers of an `nn.Module`) broadcast in place."""
    del mesh   # the mesh spans the whole process group
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, 0)
        return tree

    def bcast(x):
        if torch.is_tensor(x):
            x = x.contiguous()
            dist.broadcast(x, 0)
        return x

    return _map(tree, bcast)


def tp_shard(x, size: int, index: int):
    """The JAX leaf rule of `shard_params_tp` on one torch tensor: its
    output-channel axis (dim 0 of Conv2d/Linear weights, of biases and of
    batch-norm vectors) split `size` ways when it is >= size and divisible
    by it, part `index` kept; anything else whole.  (JAX shards the last
    axis of HWIO and [in, out] kernels, which is this axis.)"""
    if x.dim() >= 1 and x.shape[0] >= size and x.shape[0] % size == 0:
        n = x.shape[0] // size
        return x[index * n:(index + 1) * n]
    return x


def shard_params_tp(mesh: DeviceMesh, tree, axis_name: str = "model"):
    """This rank's shard of every tensor (or numpy array) of `tree`, e.g. a
    `state_dict`, over the mesh's `axis_name` (`tp_shard`)."""
    size, index = axis_size(mesh, axis_name), axis_index(mesh, axis_name)

    def put(x):
        if isinstance(x, np.ndarray):
            return tp_shard(torch.from_numpy(x), size, index).numpy()
        return tp_shard(x, size, index) if torch.is_tensor(x) else x

    return _map(tree, put)
