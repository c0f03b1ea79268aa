"""MSC generator: message sequence charts from control-plane exchanges.

Reference parity: common/utils/msc — every inter-entity message (RRC,
S1AP, NAS) is recorded as a (time, src, dst, label) event and rendered
as a sequence chart. Output here is mscgen-compatible text plus an ASCII
rendering, produced from the same event stream the EPC entities emit.

A copy of openair4g_tpu/utils/msc.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class MscEvent:
    t: int
    src: str
    dst: str
    label: str


@dataclass
class Msc:
    """Event recorder + renderer. Entities call `record`; epc/ modules
    accept an optional Msc and tag every PDU they exchange."""
    events: list = field(default_factory=list)
    clock: int = 0

    def tick(self, t: int | None = None) -> None:
        self.clock = self.clock + 1 if t is None else t

    def record(self, src: str, dst: str, label: str) -> None:
        self.events.append(MscEvent(self.clock, src, dst, label))

    @property
    def entities(self) -> list:
        seen: list = []
        for e in self.events:
            for x in (e.src, e.dst):
                if x not in seen:
                    seen.append(x)
        return seen

    def render_mscgen(self) -> str:
        ents = ", ".join(e.lower() for e in self.entities)
        lines = [f"msc {{", f"  {ents};"]
        for e in self.events:
            lines.append(f'  {e.src.lower()} -> {e.dst.lower()} '
                         f'[ label = "{e.label}" ];')
        lines.append("}")
        return "\n".join(lines)

    def render_ascii(self, width: int = 16) -> str:
        ents = self.entities
        pos = {e: i for i, e in enumerate(ents)}
        out = ["".join(f"{e:^{width}}" for e in ents)]
        for e in self.events:
            a, b = pos[e.src], pos[e.dst]
            lo, hi = min(a, b), max(a, b)
            row = [" " * width] * len(ents)
            span = (hi - lo) * width
            arrow = ("-" * (span - 2) + ">") if a < b else \
                ("<" + "-" * (span - 2))
            line = "".join(row[:lo]) + " " * (width // 2) + arrow
            out.append(line[:width * len(ents)])
            out.append(f"{' ' * (lo * width + width // 2)}  {e.label}")
        return "\n".join(out)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render_mscgen())
