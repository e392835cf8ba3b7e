"""Runtime profiling buckets.

Preserves the reference's dt/pt/pn bucket API (`betapose_evaluate.py:132-136`,
`fn.py:222-227` getTime).  The buckets are wall-clock: a caller timing
device work synchronizes the device inside the bucket
(`PosePipeline.profiled_call`).  `device_trace` captures a torch.profiler
trace, the counterpart of the JAX package's `jax.profiler` trace.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


class RuntimeProfile:
    """Named wall-clock buckets: dt (detection), pt (pose), pn (post)."""

    def __init__(self, names=("dt", "pt", "pn")):
        self.buckets = {n: [] for n in names}

    @contextlib.contextmanager
    def bucket(self, name):
        if name not in self.buckets:
            self.buckets[name] = []
        t0 = time.perf_counter()
        yield
        self.buckets[name].append(time.perf_counter() - t0)

    def mean(self, name):
        b = self.buckets.get(name, [])
        return sum(b) / len(b) if b else 0.0

    def summary(self):
        return " | ".join(f"{n}: {self.mean(n):.4f}"
                          for n in self.buckets if self.buckets[n])


def chain_ms(step, device, k=20, rounds=5, warmup=2):
    """Milliseconds per call of `step()`: the median over `rounds` of `k`
    calls in a row, divided by k, after `warmup` calls.  On a CUDA device
    the k calls sit between two CUDA events (device time; the host's launch
    cost shows only where the device waits for it); on the CPU the host
    clock is read.  `step` carries its own data dependency from call to
    call where the caller wants one."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        step()
    if cuda:
        torch.cuda.synchronize(device)
    per = []
    for _ in range(rounds):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                step()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / k)
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                step()
            per.append((time.perf_counter() - t0) * 1e3 / k)
    return statistics.median(per)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block, CPU and (where there is one) CUDA
    activity; the chrome trace goes to `logdir/trace.json` (open it in
    chrome://tracing or Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
