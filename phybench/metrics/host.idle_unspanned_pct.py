"""The share of the device's idle time in the traced window during which
the host was in none of the program's own spans (phybench/spans.py): each
idle gap placed at its middle, as the breakdown's idle_gaps are, and the
gaps outside every oai4g: span summed, as % of all idle time. The rest
of the idle time has a layer that made it. Also puts on stderr, for each
span label and for the host outside them, the host ms, device ms,
launches, syncs and idle ms a step."""
import sys

from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "host.idle_unspanned_pct", device=True)
    if s is None:
        return None
    for lab, row in s.table().items():
        print(f"phybench: span {lab}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in zip(
                ("host_ms", "device_ms", "launches", "syncs", "idle_ms"),
                row) if v is not None) + " a step", file=sys.stderr)
    return s.idle_unspanned_pct()
