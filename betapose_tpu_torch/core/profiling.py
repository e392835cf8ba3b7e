"""Runtime profiling buckets.

Preserves the reference's dt/pt/pn bucket API (`betapose_evaluate.py:132-136`,
`fn.py:222-227` getTime).  Wall-clock only: a caller timing device work
synchronizes the device inside the bucket (`PosePipeline.profiled_call`).
"""

from __future__ import annotations

import contextlib
import time


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
