"""The port imports without JAX: the machine with the card has none installed."""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import openmcmc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(openmcmc_tpu_torch.__path__, "openmcmc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "openmcmc_tpu" or k.startswith("openmcmc_tpu.") for k in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module and subpackage of the port, 35 once linalg.gamma and
    # checkpoint are in
    assert int(out.stdout.strip()) >= 35, out.stdout
