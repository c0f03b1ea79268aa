"""The general generator: one step's inputs drawn on the device from a
torch.Generator seeded by --seed, from a plan of (key, kind, shape) that
the simulator's module under sims/ builds out of its configuration and
traffic mix. The same seed
gives the same inputs, on any device of one kind."""
from __future__ import annotations

import random

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator of `device` seeded by `seed` (any whole number up to
    2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)


def draw(plan, gen: torch.Generator, device) -> dict:
    """{key: tensor} for plan [(key, kind, shape)], in plan order: kind
    "bits" is int32 {0, 1}, "normal" standard normal float32; a key
    "a/b" lands under out["a"]["b"] and "a/3" under out["a"][3]."""
    out: dict = {}
    for key, kind, shape in plan:
        if kind == "bits":
            t = torch.randint(0, 2, shape, generator=gen, device=device,
                              dtype=torch.int32)
        elif kind == "normal":
            t = torch.randn(shape, generator=gen, device=device)
        else:
            raise ValueError(f"draw: kind {kind!r} of {key}")
        *path, last = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[int(last) if last.isdigit() else last] = t
    return out


class Reservoir:
    """A uniform sample of k steps out of however many a window runs,
    drawn from the seed before each step runs (reservoir sampling), so
    that only the steps kept are recorded."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(int(seed))
        self.kept: dict = {}
        self.seen = 0

    def slot(self):
        """The slot the next step goes to, or None: call once a step."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None

    def keep(self, slot, record) -> None:
        self.kept[slot] = record

    def records(self) -> list:
        return [self.kept[s] for s in sorted(self.kept)]
