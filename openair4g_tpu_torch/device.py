"""Device selection, float32 matmul precision, and kernel launch counters.

Importing this module turns TF32 off for matmuls and cuDNN: the port's
soft values are held to the JAX reference in full float32, and the CRC
GF(2) products must stay exact sums.
"""
from __future__ import annotations

import subprocess
import sys

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s, and float32 operations/s outside the tensor cores. The data
# sheet's 67 TFLOP/s counts an FMA as two; the kernels' add, sub, max and
# mul issue one a lane a cycle, so an operation counts at half that rate.
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12 / 2

# One count per hand-written kernel: each wrapper adds one where it
# launches its kernel, and nowhere else; the same launches by (kernel,
# shape), the shape as the wrapper describes it.
_LAUNCHES = {"turbo_half_iter": 0, "turbo_half_iter_v1": 0, "turbo_decode": 0,
             "mrc_llr": 0, "demap_llr": 0, "viterbi": 0, "viterbi_search": 0,
             "dlsch_encode": 0, "dlsch_select": 0, "dlsch_dematch": 0,
             "dlsch_tb_check": 0}
_SHAPES: dict = {}


# Static plans (index maps, tables) uploaded once per (host array, build,
# device); the entry holds the host object, so its id stays its own.
_PLANS: dict = {}


def device_plan(host, device, build=None, dtype=None) -> torch.Tensor:
    """`build(host)` (or `host` itself), a static plan built on the host,
    as a tensor on `device`, uploaded on the first call only. `host` must
    outlive the process's use of it (a module constant or what an
    lru_cache returns), and `build` be a module-level function: a fresh
    array on every call would fill the cache."""
    dev = torch.device(device)
    key = (id(host), build, str(dev), dtype)
    hit = _PLANS.get(key)
    if hit is None:
        value = host if build is None else build(host)
        hit = _PLANS[key] = (host, torch.as_tensor(value, dtype=dtype,
                                                   device=dev))
    return hit[1]


def default_device() -> torch.device:
    """`cuda`, the device an entry point runs on unless its caller names
    another. Raises RuntimeError when no card is present: the CPU runs only
    when asked for (`device="cpu"`), as the tests do."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """An entry point's `device` argument: None means default_device() (the
    card, raising without one); any other value is the device it names."""
    return default_device() if device is None else torch.device(device)


def cli_device(prog: str, name: str) -> torch.device:
    """A command line's --device: a CUDA device that is not there ends the
    program with an error; it never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{prog}: --device {name} but no CUDA device is present "
                 "(pass --device cpu to run on the CPU)")
    return dev


def card_name(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them; "cpu" for a CPU device,
    whose times are no device metric."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def count_launch(name: str, shape: tuple) -> None:
    _LAUNCHES[name] += 1
    _SHAPES[name, shape] = _SHAPES.get((name, shape), 0) + 1


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
    _SHAPES.clear()


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def launch_shapes() -> dict:
    """{(kernel, shape): launches} since the last reset_launch_counts()."""
    return dict(_SHAPES)
