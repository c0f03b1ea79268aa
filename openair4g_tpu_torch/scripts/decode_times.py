"""The turbo decode kernel's device time at the keys the paths give it, on
a GPU:

    python3 -m openair4g_tpu_torch.scripts.decode_times [--only LABEL]
        [--out FILE]

Keys (B rows, K, F, W, U, iterations, CRC, dynamic stop): the flagship's
group (1,408 x 5,632, 8 iterations, crc24b, dynamic stop), the full-width
uplink's (1,024 x 5,504), the MBSFN path's (1,024 x 5,888), the full-PHY
oaisim's (640 x 6,144, 6 iterations), the bench's turbo cell (1,024 x
4,032, fixed 8 and dynamic stop), five of the per-TTI, campaign and
capstone groups (896 x 5,824 to 4 x 3,520), the capstones' and anchors'
batch-1 groups (1 x 200 to 3,648) and a row of 154 windows (16 x 6,144,
W = 40).
Inputs: blocks coded on the card with noise rising over the rows (sigma
1.6 to 3.6, so rows latch early, late and never); the flagship group also
at 8 fixed iterations on pure noise, where no row latches, so every row
runs every iteration. Each time: torch.profiler's device time of the
decode kernel over N_CALLS calls, a call; with this tree's kernel, also
the layout the launch chose (rows a block, on chip or staged) and the
mean over blocks of the block's largest iteration count.
Prints a line a reading and the card's name and power limit; --out writes
them as JSON. Runs in any tree whose ops.turbo.turbo_decode launches the
kernel (so an A/B copies this file into the parent's tree).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..ops import turbo as turbo_mod
from ..ops import turbo_cuda
from ..ops.crc import crc_device

N_CALLS = 10
KERNEL = "turbo_decode_kernel"
# (label, B, K, F, W, U, n_iter, CRC, dynamic stop)
KEYS = [
    ("flagship", 1408, 5632, 0, 240, 24, 8, "crc24b", True),
    ("uplink", 1024, 5504, 0, 240, 24, 8, "crc24b", True),
    ("MBSFN", 1024, 5888, 0, 240, 24, 8, "crc24b", True),
    ("oaisim", 640, 6144, 0, 240, 24, 6, "crc24b", True),
    ("bench fixed", 1024, 4032, 0, 240, 24, 8, "crc24b", False),
    ("bench dynamic", 1024, 4032, 0, 240, 24, 8, "crc24b", True),
    ("896 x 5824", 896, 5824, 0, 240, 24, 6, "crc24b", True),
    ("256 x 5376", 256, 5376, 0, 240, 24, 8, "crc24b", True),
    ("128 x 5760", 128, 5760, 0, 240, 24, 8, "crc24a", True),
    ("16 x 1824", 16, 1824, 0, 240, 24, 6, "crc24a", True),
    ("4 x 3520", 4, 3520, 0, 240, 24, 4, "crc24a", True),
    ("batch-1 K 200", 1, 200, 0, 240, 24, 8, "crc24a", True),
    ("batch-1 K 832", 1, 832, 0, 240, 24, 8, "crc24a", True),
    ("batch-1 K 3648", 1, 3648, 0, 240, 24, 8, "crc24a", True),
    ("154 windows", 16, 6144, 0, 40, 8, 8, "crc24a", True),
]


def coded_inputs(B: int, K: int, F: int, crc_kind: str, dev, gen):
    """[B, 3, K + 4] LLRs of B code blocks coded on the card: F filler
    zeros (their d0/d1 LLRs +1e4), a random payload and its CRC; LLR = 2
    (1 - 2 d) + sigma N(0, 1), sigma from 1.6 to 3.6 over the rows."""
    payload = torch.randint(0, 2, (B, K - F - 24), generator=gen,
                            device=dev, dtype=torch.int32)
    bits = torch.cat([payload.new_zeros(B, F), payload,
                      crc_device(payload, crc_kind).to(torch.int32)], dim=1)
    d = turbo_mod.turbo_encode_device(bits, turbo_mod.qpp_interleaver(K))
    sigma = torch.linspace(1.6, 3.6, B, device=dev)[:, None, None]
    llr = 2.0 * (1.0 - 2.0 * d.to(torch.float32)) + sigma * torch.randn(
        d.shape, generator=gen, device=dev)
    llr[:, :2, :F] = 1e4
    return llr


def device_ms(fn) -> float:
    """The decode kernel's device time a call, by torch.profiler over
    N_CALLS calls (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(N_CALLS):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if KERNEL in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / N_CALLS


def block_iterations(iters, rows: int) -> float:
    """The mean over blocks of rows rows of the block's largest iteration
    count (what a block runs: its rows step together)."""
    n = iters.numel()
    pad = torch.zeros(-(-n // rows) * rows, dtype=iters.dtype,
                      device=iters.device)
    pad[:n] = iters
    return pad.reshape(-1, rows).max(dim=1).values.double().mean().item()


def reading(label, llr, cfg) -> dict:
    """One timed decode: device ms, the rows latched and the mean
    iterations (and with this tree's kernel, the blocks' mean largest)."""
    it = torch.zeros(llr.shape[0], dtype=torch.int32, device=llr.device)
    dyn = turbo_mod.TurboDecoderConfig(**{**cfg.__dict__,
                                          "dynamic_stop": True})

    def call(c=cfg, iters=None):
        return turbo_mod.turbo_decode(llr, c, iters)
    ok = call(dyn, it)[1]
    row = {"label": label, "B": llr.shape[0], "K": cfg.K, "F": cfg.F,
           "W": cfg.window, "U": cfg.warmup, "n_iter": cfg.n_iter,
           "crc": cfg.crc_kind, "dynamic_stop": cfg.dynamic_stop,
           "device_ms": device_ms(call), "latched": int(ok.sum()),
           "mean_iterations": it.double().mean().item()}
    if hasattr(turbo_cuda, "decode_plan"):
        rows, staged = turbo_cuda.decode_plan(llr.shape[0], cfg.K,
                                              cfg.window)
        row.update(rows=rows, staged=staged,
                   block_iterations=block_iterations(it, rows))
    print(f"{label}: {row['B']} x K = {cfg.K}, W = {cfg.window}, "
          f"{cfg.n_iter} iterations, dynamic_stop {cfg.dynamic_stop}: "
          f"{row['device_ms']:.4f} ms device;"
          f" {row['latched']} latched, mean iterations "
          f"{row['mean_iterations']:.3f}"
          + (f", blocks' mean largest {row['block_iterations']:.3f} at "
             f"{row['rows']} rows a block, "
             f"{'staged' if row['staged'] else 'on chip'}"
             if "rows" in row else ""),
          flush=True)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="decode_times")
    ap.add_argument("--only", action="append", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_times: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for label, B, K, F, W, U, n_iter, crc, dyn in KEYS:
        if args.only and label not in args.only:
            continue
        cfg = turbo_mod.TurboDecoderConfig(K=K, F=F, n_iter=n_iter, window=W,
                                           warmup=U, crc_kind=crc,
                                           dynamic_stop=dyn)
        llr = coded_inputs(B, K, F, crc, dev, gen)
        try:
            rows.append(reading(label, llr, cfg))
        except ValueError as e:     # a kernel that refuses the key
            print(f"{label}: refused: {e}", flush=True)
            continue
        if label == "flagship":
            fixed = turbo_mod.TurboDecoderConfig(**{**cfg.__dict__,
                                                    "dynamic_stop": False})
            noise = 3.0 * torch.randn(llr.shape, generator=gen, device=dev)
            rows.append(reading(label + " fixed", llr, fixed))
            rows.append(reading(label + " fixed, noise", noise, fixed))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
