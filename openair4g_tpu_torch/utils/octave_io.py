"""Octave .m debug dumps (the reference's write_output format): a copy of
openair4g_tpu/utils/octave_io.py, which imports numpy only.

Reference parity: openair1/PHY/TOOLS/file_output.c (write_output — dumps
int/float/complex buffers as `name = [ ... ];` Octave assignments used all
over the reference for offline analysis).
"""
from __future__ import annotations

import numpy as np


def write_output(path: str, name: str, data, append: bool = False) -> None:
    """Dump an array as an Octave-loadable assignment (complex supported)."""
    a = np.asarray(data).reshape(-1)
    mode = "a" if append else "w"
    with open(path, mode) as f:
        f.write(f"{name} = [")
        if np.iscomplexobj(a):
            f.write(", ".join(f"({v.real:.9g}{v.imag:+.9g}*i)" for v in a))
        else:
            f.write(", ".join(f"{v:.9g}" for v in a))
        f.write("];\n")


def read_output(path: str) -> dict:
    """Parse write_output dumps back into numpy arrays."""
    out = {}
    with open(path) as f:
        txt = f.read()
    for stmt in txt.split(";"):
        stmt = stmt.strip()
        if not stmt or "=" not in stmt:
            continue
        name, rhs = stmt.split("=", 1)
        rhs = rhs.strip().lstrip("[").rstrip("]")
        vals = []
        cplx = False
        for tok in rhs.split(","):
            tok = tok.strip().strip("()")
            if not tok:
                continue
            if "*i" in tok or "i" == tok[-1:]:
                cplx = True
                tok = tok.replace("*i", "j").replace("i", "j")
                # "a+bj" form
                vals.append(complex(tok))
            else:
                vals.append(float(tok))
        out[name.strip()] = np.asarray(vals,
                                       np.complex128 if cplx else np.float64)
    return out
