"""Devices, static plans on a device, and the matrix product that carries
the control's precision."""
from __future__ import annotations

import torch

# Static plans (index maps, tables) uploaded once per (host array, build,
# device); the entry holds the host object, so its id stays its own.
_PLANS: dict = {}


def device_plan(host, device, build=None, dtype=None) -> torch.Tensor:
    """`build(host)` (or `host` itself) as a tensor on `device`, uploaded on
    the first call only. `host` must outlive the process's use of it."""
    dev = torch.device(device)
    key = (id(host), build, str(dev), dtype)
    hit = _PLANS.get(key)
    if hit is None:
        value = host if build is None else build(host)
        hit = _PLANS[key] = (host, torch.as_tensor(value, dtype=dtype,
                                                   device=dev))
    return hit[1]


def resolve_device(device) -> torch.device:
    if device is None:
        raise ValueError("the reference runs on the device it is given")
    return torch.device(device)


def to_tf32(x):
    """x (float32 or complex64) with each float rounded to TF32's 10
    mantissa bits, to nearest, ties to even."""
    r = torch.view_as_real(x) if x.is_complex() else x
    i = r.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    r = i.view(torch.float32)
    return torch.view_as_complex(r) if x.is_complex() else r


def mm(a, b):
    """a @ b; while torch.backends.cuda.matmul.allow_tf32 is on, the
    operands rounded to TF32 first, as the tensor cores take them."""
    if torch.backends.cuda.matmul.allow_tf32:
        return to_tf32(a) @ to_tf32(b)
    return a @ b
