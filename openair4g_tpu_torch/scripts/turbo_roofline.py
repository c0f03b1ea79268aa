"""The turbo decoder's split against its ceiling (counterpart of
scripts/turbo_roofline.py).

On the attached device: the decode at n_iter iterations and at 1 (all
iterations run: dynamic_stop off), so the slope a iteration and the fixed
overhead; one QPP permute; one half-iteration by the v2 kernel and by its
plain version; the CRC check. The ceiling is the card's, computed as
PERF.md's kernel table does: 2 n_iter half-iterations a decode, each
moving 3 x 4 bytes a trellis position (lin and lp in, out) over 3.35 TB/s
and doing TURBO_OPS_PER_POS float32 operations a position over 33.5 T/s
(NVIDIA H100 SXM, 700 W); the combined ceiling is the lower of the two
rates, stated beside the card's name and power limit.

    python3 -m openair4g_tpu_torch.scripts.turbo_roofline [K] [batch]
        [n_iter] [--device cuda] [--out-dir DIR]

The decoder's window is the card's (W = 240, U = 24; W = 96 on the CPU).
Timing: the best of 3 windows of 5 calls on the host clock between
device syncs, after one warm-up call. Writes DIR/turbo_roofline.json
(resume: an existing file is not run again).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..bench import time_windows
from ..device import FP32_OPS_S, HBM_BYTES_S
from ..ops import turbo
from ..ops.turbo_cuda import TURBO_OPS_PER_POS, half_iteration_ref
from . import common

N_REP, WINDOWS = 5, 3


def _ms(fn, dev) -> float:
    return min(time_windows(fn, dev, N_REP, WINDOWS)[0]) / N_REP * 1e3


def run(K: int, B: int, n_iter: int, dev) -> dict:
    W, U = (240, 24) if dev.type == "cuda" else (96, 24)
    rng = np.random.default_rng(0)
    d1 = turbo.turbo_encode_host(rng.integers(0, 2, K))        # [3, K+4]
    llr = torch.as_tensor((1.0 - 2.0 * np.broadcast_to(d1, (B,) + d1.shape))
                          * 4.0, dtype=torch.float32, device=dev)
    out = {"K": K, "batch": B, "n_iter": n_iter, "backend": dev.type,
           "window": W, "warmup": U}
    for it in (n_iter, 1):
        cfg = turbo.TurboDecoderConfig(K=K, F=0, n_iter=it, window=W,
                                       warmup=U, crc_kind="crc24a",
                                       dynamic_stop=False)
        ms = _ms(lambda c=cfg: turbo.turbo_decode(llr, c), dev)
        out[f"decode_{it}iter_ms"] = ms
        out[f"decode_{it}iter_mbps"] = B * K / ms / 1e3
        print(f"decode {it} iter: {ms:.3f} ms "
              f"({out[f'decode_{it}iter_mbps']:.1f} Mbit/s)", flush=True)
    per_iter = (out[f"decode_{n_iter}iter_ms"] - out["decode_1iter_ms"]) \
        / max(n_iter - 1, 1)
    out["per_iteration_ms"] = per_iter
    out["fixed_overhead_ms"] = out["decode_1iter_ms"] - per_iter

    x = torch.as_tensor(rng.normal(size=(B, K)), dtype=torch.float32,
                        device=dev)
    out["permute_ms"] = _ms(lambda: turbo._permute(x, K, False), dev)
    N = turbo._padded_len(K + 3, W)
    lin, lp = (torch.as_tensor(rng.normal(size=(B, N)), dtype=torch.float32,
                               device=dev) for _ in range(2))
    out["half_iteration_ms"] = _ms(
        lambda: turbo.half_iteration(lin, lp, W, U), dev)
    out["half_iteration_plain_ms"] = _ms(
        lambda: half_iteration_ref(lin, lp, W, U), dev)
    crc = turbo._make_crc_checker(K, "crc24a")
    bits = torch.as_tensor(rng.integers(0, 2, (B, K)), dtype=torch.int32,
                           device=dev)
    out["crc_check_ms"] = _ms(lambda: crc(bits), dev)

    half_iters = 2 * n_iter
    t_bytes = half_iters * 3 * 4 * B * N / HBM_BYTES_S
    t_ops = half_iters * TURBO_OPS_PER_POS * B * N / FP32_OPS_S
    out["bytes_ceiling_gbps"] = B * K / t_bytes / 1e9
    out["ops_ceiling_gbps"] = B * K / t_ops / 1e9
    out["combined_ceiling_gbps"] = B * K / max(t_bytes, t_ops) / 1e9
    out["achieved_gbps"] = out[f"decode_{n_iter}iter_mbps"] / 1e3
    out["fraction_of_ceiling"] = out["achieved_gbps"] / \
        out["combined_ceiling_gbps"]
    out["note"] = ("ceilings: the v2 kernel's bytes (3 x 4 a position) "
                   "and float32 operations (TURBO_OPS_PER_POS a position) "
                   "of 2 n_iter half-iterations over the NVIDIA H100 SXM "
                   "peaks at 700 W (3.35 TB/s, 33.5 T operations/s); "
                   "times are synced host-clock windows")
    return out


def main(argv=None) -> dict:
    p = common.parser("turbo_roofline", __doc__)
    p.add_argument("K", nargs="?", type=int, default=1824)
    p.add_argument("batch", nargs="?", type=int, default=512)
    p.add_argument("n_iter", nargs="?", type=int, default=8)
    a = p.parse_args(argv)
    dev, out, card = common.setup("turbo_roofline", a)
    res = common.run_each(["turbo_roofline"], out,
                          lambda _: run(a.K, a.batch, a.n_iter, dev), card)
    print(json.dumps(res["turbo_roofline"], indent=1))
    return res["turbo_roofline"]


if __name__ == "__main__":
    main()
