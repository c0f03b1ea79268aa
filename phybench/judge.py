"""Arithmetic shared by the simulators' comparisons with the reference."""
from __future__ import annotations

import torch


def row_gap(port: list, ref: list) -> torch.Tensor:
    """Each row's relative gap between two lists of [n, L] soft-value
    blocks: ||port - ref|| / max(||port||, ||ref||) over the row's blocks
    together, in float64; 0 where both are zero, at most 2."""
    num = sum(((p.double() - r.double()) ** 2).sum(dim=1)
              for p, r in zip(port, ref))
    den = torch.maximum(sum((p.double() ** 2).sum(dim=1) for p in port),
                        sum((r.double() ** 2).sum(dim=1) for r in ref))
    return torch.sqrt(num) / torch.sqrt(den).clamp(min=1e-300)


def chunks(n: int, size: int):
    """(start, end) of consecutive chunks of at most `size` of n rows."""
    return [(s, min(s + size, n)) for s in range(0, n, size)]


def cat_rows(records: list, get) -> torch.Tensor:
    """get(record) of every record, concatenated along the rows."""
    return torch.cat([get(r) for r in records], dim=0)


def cat_blocks(records: list, get) -> list:
    """get(record) (a list of per-block [B, L] tensors) of every record,
    each block concatenated along the rows."""
    per = [get(r) for r in records]
    return [torch.cat([p[i] for p in per], dim=0) for i in range(len(per[0]))]
