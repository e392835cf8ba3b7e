"""n ranks, one process per device: the port's counterpart of "n devices
in one process" (the JAX package's mesh over `jax.devices()`).

`run_ranks(fn, world, device, *args)` spawns `world` processes.  Rank r
runs `fn(*args)` on `cuda:r` under NCCL, or on the CPU under gloo when the
caller asks for it (`device="cpu"`).  The ranks meet through a
`FileStore` in a temporary directory, so no port is opened; `fn` and
its arguments are pickled once into the same directory, from which every
rank loads them (handing them to each spawn instead keeps the caller
writing each copy until that rank has started).  Rank 0's
return value comes back to the caller (it must pickle: numpy arrays or
CPU tensors); an exception in any rank is raised in the caller with that
rank's traceback.  `fn` must be importable by name in a fresh process (a
module-level function); it finds the process group initialized and, on
CUDA, its device current.

    def work(n):
        mesh = make_mesh(4)              # parallel/mesh.py
        ...
    run_ranks(work, 4, "cpu", 7)

`single_rank(device)` makes a process group of the calling process alone
(world size 1), for running the data-parallel paths on networks it
already holds.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def device_type(device=None) -> str:
    """"cuda" unless the caller asks for the CPU (the port's rule)."""
    return torch.device("cuda" if device is None else device).type


def backend_for(dev_type: str) -> str:
    return "nccl" if dev_type == "cuda" else "gloo"


def _rank_main(rank, world, dev_type, store_path, threads, call_path,
               queue):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if dev_type == "cuda":
            from betapose_tpu_torch.core.device import resolve_device
            torch.cuda.set_device(rank)
            dev = resolve_device(f"cuda:{rank}")
        else:
            torch.set_num_threads(threads)
            dev = torch.device("cpu")
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend_for(dev_type), store=store,
                                rank=rank, world_size=world,
                                **({"device_id": dev} if dev_type == "cuda"
                                   else {}))
        out = fn(*args)
        dist.barrier()
        queue.put((rank, None, out if rank == 0 else None))
    except BaseException:   # noqa: BLE001 - handed to the caller
        # reported before the group goes down: tearing it down may wait
        # on peers stuck in a collective, which the caller then ends
        queue.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def single_rank(device=None):
    """A process group of this process alone (world size 1) for the block,
    under the backend of `device` (NCCL on the current CUDA device unless
    the CPU is asked for): the data-parallel code paths run here on
    networks this process already holds.  Yields the device; the group is
    destroyed on exit."""
    from betapose_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory(prefix="rank_") as tmp:
        dist.init_process_group(
            backend_for(dev.type),
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
            world_size=1, **({"device_id": dev} if dev.type == "cuda"
                             else {}))
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def run_ranks(fn, world: int, device=None, *args):
    """Run fn(*args) on `world` ranks; returns rank 0's value."""
    dev_type = device_type(device)
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "ranks on the CPU")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"{world} ranks need {world} CUDA devices, found "
                f"{torch.cuda.device_count()}")
    threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        store = os.path.join(tmp, "store")
        call = os.path.join(tmp, "call")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, dev_type, store, threads, call,
                                   queue), daemon=False)
                 for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            while len(results) < world and not errors:
                try:
                    rank, err, out = queue.get(timeout=1.0)
                except queue_mod.Empty:
                    # a rank that died without a word (a signal, a crash
                    # in native code) would leave the others waiting
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        errors.append((dead[0][0], "exited with code "
                                       f"{dead[0][1]}"))
                    continue
                if err is not None:
                    errors.append((rank, err))
                else:
                    results[rank] = out
            # the other ranks' errors, for a moment
            deadline = time.monotonic() + 2.0
            while errors and len(results) + len(errors) < world \
                    and time.monotonic() < deadline:
                try:
                    rank, err, out = queue.get(timeout=0.2)
                except queue_mod.Empty:
                    continue
                if err is not None:
                    errors.append((rank, err))
        finally:
            for p in procs:
                if errors:
                    p.terminate()
                p.join()
    if errors:
        # a rank's failure breaks its peers' collectives too: name the
        # rank whose error is not a collective's
        rank, err = min(errors, key=lambda e: "distributed" in e[1])
        raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
    return results[0]
