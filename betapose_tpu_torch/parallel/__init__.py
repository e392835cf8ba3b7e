"""Parallelism over several devices: data, tensor (channel) and spatial.

Counterpart of `betapose_tpu/parallel/`, where one process drives n
devices and XLA/GSPMD inserts the collectives from sharding annotations.
Here each device has a process of its own (`launch.run_ranks`), the mesh
is a `torch.distributed` `DeviceMesh` (`mesh.make_mesh`) and the
collectives are written out (`collectives`): gradient all-reduce and
batch-norm statistics for data parallelism, column-parallel layers for
tensor parallelism (`layers`), halo exchange for spatial partitioning
(`spatial`), and the sharded pose pipeline over all three (`inference`).
"""
