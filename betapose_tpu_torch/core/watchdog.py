"""Stall watchdog: turn a device call that hangs into a fast failure.

A device call can block forever inside native code (a hung CUDA runtime
call, a wedged collective), which Python cannot interrupt: no exception,
no timeout, the process simply stops making progress.  `StallWatchdog` turns
liveness into a checkable signal: the driving host loop calls `beat()`
once per iteration (a `time.monotonic()` store, no device sync), a daemon
thread watches the gap, and on timeout it prints a diagnostic and
hard-exits the process.  `os._exit` is deliberate: the main thread is
blocked inside a native call that will never return to the interpreter,
so exceptions, `sys.exit` and Python signal handlers never run.  The
long-running tiers pair the watchdog with their weight caches
(`--params_dir` in sweep / occl_multiobj): rerunning the command resumes
from the last completed stage.

A copy of the JAX package's `core/watchdog.py` (it uses no framework).
The chip claim lives in the temporary directory (`tempfile.gettempdir()`,
which `TMPDIR` sets), not at a fixed path under /tmp.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time


def chip_claim_path() -> str:
    """The claim file.  One card, several long-running programs: a
    measurement process CLAIMS the card by writing this file; cooperating
    training tiers (sweep / occl_multiobj, armed via `yield_to=` and
    checked once at start) notice the claim and exit with code 4, which
    their weight caches and incremental --out_json rows make loss-free.
    Without this, a measurement that lands mid-training shares the device
    with training and records garbage latencies.  The file lives in the
    temporary directory, resolved at call time (`tempfile.gettempdir()`
    probes the directory)."""
    return os.path.join(tempfile.gettempdir(), "betapose_chip_claim")


#: Claims older than this are treated as leaked (a crashed bench that
#: never reached its finally:) and ignored.
CHIP_CLAIM_STALE_S = 1800.0


def claim_chip(label: str = "", path: str | None = None) -> None:
    """Claim measurement priority on the chip (see `chip_claim_path`)."""
    with open(path or chip_claim_path(), "w") as f:
        f.write(f"{os.getpid()} {label}\n")


def release_chip(path: str | None = None) -> None:
    try:
        os.unlink(path or chip_claim_path())
    except OSError:
        pass


def chip_claimed(path: str | None = None,
                 stale_s: float = CHIP_CLAIM_STALE_S) -> bool:
    """True iff a fresh (non-stale) chip claim exists."""
    try:
        age = time.time() - os.stat(path or chip_claim_path()).st_mtime
    except OSError:
        return False
    return age < stale_s


def refuse_if_claimed(label: str) -> None:
    """Exit with code 4 (the watchdog's yield code) before touching the
    device when a measurement run claims the card."""
    if chip_claimed():
        print(f"{label}: the card is claimed by a measurement run "
              f"({chip_claim_path()}); rerun once the claim clears",
              file=sys.stderr)
        raise SystemExit(4)


class StallWatchdog:
    """Daemon-thread liveness monitor.

    Usage::

        with StallWatchdog(900, label="sweep") as wd:
            for it in range(iters):
                ...host-driven device step...
                wd.beat()

    If `beat()` (or entry) hasn't been called for `timeout_s` seconds,
    the monitor prints a diagnostic to stderr and calls `exit_fn`
    (default `os._exit(exit_code)`).  `timeout_s <= 0` disables the
    watchdog entirely (no thread is started), so callers can plumb a
    CLI knob straight through.

    beat() is safe from any thread and costs one monotonic-clock read.

    `yield_to` (a chip-claim path, normally `chip_claim_path()`) makes the
    monitor also exit — with `yield_exit_code` (4) — as soon as a fresh
    claim file appears, so a measurement process gets the chip to
    itself.  Callers that arm it must be resumable (weight caches /
    incremental output), exactly like the stall exit.
    """

    def __init__(self, timeout_s: float, label: str = "",
                 exit_code: int = 3, check_every: float = 5.0,
                 exit_fn=None, yield_to: str | None = None,
                 yield_exit_code: int = 4):
        self.timeout_s = float(timeout_s)
        self.label = label
        self.exit_code = exit_code
        self.check_every = float(check_every)
        self.yield_to = yield_to
        self.yield_exit_code = yield_exit_code
        self._exit_fn = exit_fn or (lambda code: os._exit(code))
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = None
        self.enabled = self.timeout_s > 0

    def beat(self) -> None:
        self._last = time.monotonic()

    def start(self) -> "StallWatchdog":
        if self.enabled and self._thread is None:
            self._last = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name=f"stall-watchdog[{self.label}]",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.check_every + 1.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- monitor thread ----

    def _run(self) -> None:
        while not self._stop.wait(self.check_every):
            if self.yield_to and chip_claimed(self.yield_to):
                print(
                    f"[stall-watchdog{':' + self.label if self.label else ''}]"
                    f" chip claimed by a measurement run ({self.yield_to})"
                    " — yielding. Rerun resumes from caches once the claim"
                    " clears.",
                    file=sys.stderr, flush=True)
                self._exit_fn(self.yield_exit_code)
                return  # only reached with an injected exit_fn (tests)
            gap = time.monotonic() - self._last
            if gap > self.timeout_s:
                print(
                    f"[stall-watchdog{':' + self.label if self.label else ''}]"
                    f" no progress for {gap:.0f}s (> {self.timeout_s:.0f}s)"
                    " — a device call is wedged."
                    " Exiting so an outer retry can resume from caches.",
                    file=sys.stderr, flush=True)
                self._exit_fn(self.exit_code)
                return  # only reached with an injected exit_fn (tests)
