"""Draw streams (counterpart of openair4g_tpu/utils/rng.py).

The reference keys each Monte-Carlo trial by (seed, global trial index)
as threefry key data (`host_keys`, kept here as a copy). Threefry cannot
be reproduced in torch, so the port's simulators draw from one
torch.Generator per sweep point instead: chunk i of a point is what the
generator gives after i earlier chunks (`DlsimAwgn.run_snr`). The
sharded sweeps keep that sequence. Every rank seeds the same generator,
draws the whole global batch of each chunk and keeps its own rows
(`rank_rows`), so a sharded run is the one-process run by construction;
a resumed point reaches chunk `stream0` by drawing and discarding the
chunks before it (`fast_forward`).

Reference parity: the reference seeds its Tausworthe RNG per trial
(SIMULATION/TOOLS/taus.c); here the (seed, chunk) pair is the stream id.
"""
from __future__ import annotations

import numpy as np
import torch


def host_keys(seed: int, n: int, stream: int = 0) -> np.ndarray:
    """[n, 2] uint32 threefry key data for trials `stream*n .. stream*n+n-1`
    of seed `seed` (the reference's keys, value for value)."""
    hi = np.full(n, np.uint32(seed & 0xFFFFFFFF), np.uint32)
    lo = (np.uint32(stream) * np.uint32(n) + np.arange(n, dtype=np.uint32))
    return np.stack([hi, lo], axis=1)


def draw_stream(seed: int, device) -> torch.Generator:
    """The generator of one sweep point: seeded with `seed` on `device`,
    as the simulators' run_snr seeds theirs."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def rank_rows(draw, rank: int, n_ranks: int):
    """Rank `rank`'s rows of a global draw: every tensor of `draw` (a
    `sim.draw` result: tensors, None entries such as the AWGN taps, and
    lists or tuples of them, such as the (normals, AoA) pair of Rice1 and
    Rice8) cut on its batch dimension into n_ranks equal blocks."""
    if draw is None:
        return None
    if isinstance(draw, (list, tuple)):
        return type(draw)(rank_rows(d, rank, n_ranks) for d in draw)
    per, rest = divmod(draw.shape[0], n_ranks)
    if rest:
        raise ValueError(f"a batch of {draw.shape[0]} does not split into "
                         f"{n_ranks} equal blocks")
    return draw[rank * per:(rank + 1) * per]


def fast_forward(sim, generator: torch.Generator, k: int) -> None:
    """Draw and discard k chunks of `sim` from `generator`, so that its
    next draw is chunk k of the point."""
    for _ in range(k):
        sim.draw(generator)
