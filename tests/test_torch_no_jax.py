"""The PyTorch port imports no JAX and nothing of the JAX package: a fresh
interpreter imports every module of `betapose_tpu_torch` and then finds
neither `jax` nor `betapose_tpu` in `sys.modules`."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import betapose_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    betapose_tpu_torch.__path__, "betapose_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "betapose_tpu"))
print(len(names), ",".join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.split()[0], proc.stdout.split()[1:]
    assert int(n_modules) >= 25
    assert bad == [], f"imported: {bad}"
