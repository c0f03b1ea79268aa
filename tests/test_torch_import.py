"""The port and chip_smoke.py import torch and never jax, nor anything of
the JAX package openair4g_tpu."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import openair4g_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_with_jax_and_the_jax_package_blocked():
    mods = ["openair4g_tpu_torch", "chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(openair4g_tpu_torch.__path__,
                                              "openair4g_tpu_torch.")]
    assert len(mods) >= 25, mods
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['openair4g_tpu'] = None\n"
            f"for name in {mods!r}:\n"
            "    importlib.import_module(name)\n"
            "leaked = sorted(k for k, v in sys.modules.items() if v is not None\n"
            "                and k.split('.')[0] in ('jax', 'openair4g_tpu'))\n"
            "assert not leaked, leaked\n"
            "print('imported')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout


def test_multi_antenna_modules_are_among_the_checked_ones():
    names = {m.name for m in pkgutil.walk_packages(
        openair4g_tpu_torch.__path__, "openair4g_tpu_torch.")}
    assert {"openair4g_tpu_torch.sim.dlsim_mimo",
            "openair4g_tpu_torch.sim.dlsim_sm",
            "openair4g_tpu_torch.phy.alamouti",
            "openair4g_tpu_torch.phy.precoding",
            "openair4g_tpu_torch.phy.mimo_rx",
            "openair4g_tpu_torch.phy.dci_formats"} <= names
