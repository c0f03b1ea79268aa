"""RRC UE: cell-acquisition + connection establishment state machine.

Reference parity: openair2/RRC/LITE/rrc_UE.c — rrc_ue_decode_ccch/dcch,
rrc_ue_generate_RRCConnectionRequest / ...SetupComplete, the T300 retry
loop and SIB bookkeeping (rrc_ue_decode_sib1/sib23). The PHY side it
drives (PSS/SSS/PBCH, PRACH+RAR via mac/ra.py) already exists; this is
the control brain that sequences them.

A copy of openair4g_tpu/rrc/ue.py.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from enum import Enum

from .messages import (Mib, Sib1, Sib2, RrcConnectionRequest,
                       RrcConnectionSetup, RrcConnectionSetupComplete,
                       RrcConnectionReconfiguration,
                       RrcConnectionReconfigurationComplete,
                       RrcConnectionRelease, RrcHandoverCommand,
                       MobilityControlInfo, decode_message)
from .phy_config import apply_sib2, apply_dedicated, CommonPhyConfig, \
    DedicatedPhyConfig


class RrcState(Enum):
    IDLE_SEARCH = 0          # hunting PSS/SSS/PBCH
    IDLE_SIB = 1             # camped; collecting SIB1/SIB2
    IDLE_READY = 2           # SI complete; may start RA
    CONNECTING = 3           # Msg3 sent, T300 running
    CONNECTED = 4


@dataclass
class RrcUe:
    """Event-driven UE RRC. Callers feed decoded PDUs; it returns what to
    send (or None) and exposes the derived PHY configs."""
    t300_ttis: int = 200
    seed: int = 0
    state: RrcState = RrcState.IDLE_SEARCH
    mib: Mib | None = None
    sib1: Sib1 | None = None
    sib2: Sib2 | None = None
    common: CommonPhyConfig | None = None
    dedicated: DedicatedPhyConfig | None = None
    crnti: int | None = None
    ue_identity: int = field(init=False)
    n_id_cell: int = 0
    _t300: int | None = None
    _setup: RrcConnectionSetup | None = None
    connection_attempts: int = 0

    def __post_init__(self):
        self.ue_identity = random.Random(self.seed).getrandbits(40)

    # ------------------------------------------------------- acquisition --
    def on_cell_found(self, n_id_cell: int, mib: Mib) -> None:
        """PSS/SSS gave the PCI, PBCH gave the MIB -> camp, want SIBs."""
        self.n_id_cell = n_id_cell
        self.mib = mib
        self.state = RrcState.IDLE_SIB

    def on_bcch(self, data: bytes) -> None:
        msg = decode_message(data)
        if isinstance(msg, Sib1):
            if msg.cell_barred:
                self.state = RrcState.IDLE_SEARCH   # reselect
                return
            self.sib1 = msg
        elif isinstance(msg, Sib2):
            self.sib2 = msg
        if self.sib1 is not None and self.sib2 is not None and \
                self.state == RrcState.IDLE_SIB:
            self.common = apply_sib2(self.mib, self.sib1, self.sib2,
                                     self.n_id_cell)
            self.state = RrcState.IDLE_READY

    # -------------------------------------------------------- connection --
    def connection_request(self, cause: int = 4) -> bytes:
        """Msg3 payload (the MAC RA procedure carries it)."""
        assert self.state == RrcState.IDLE_READY, self.state
        self.state = RrcState.CONNECTING
        self._t300 = self.t300_ttis
        self.connection_attempts += 1
        return RrcConnectionRequest(ue_identity=self.ue_identity,
                                    establishment_cause=cause).pack()

    def on_ccch(self, crnti: int, data: bytes) -> bytes | None:
        """Msg4. Returns SetupComplete (for SRB1) when the echoed identity
        is ours — contention resolution; otherwise we lost and go back to
        IDLE_READY (36.321 §5.1.5)."""
        msg = decode_message(data)
        assert isinstance(msg, RrcConnectionSetup)
        if msg.ue_identity != self.ue_identity:
            self.state = RrcState.IDLE_READY
            return None
        self.crnti = crnti
        self._setup = msg
        self._t300 = None
        self.dedicated = apply_dedicated(msg, self.common)
        self.state = RrcState.CONNECTED
        return RrcConnectionSetupComplete().pack()

    def on_dcch(self, data: bytes) -> bytes | None:
        msg = decode_message(data)
        if isinstance(msg, RrcHandoverCommand):
            # reconfiguration w/ mobilityControlInfo (rrc_UE.c handover
            # branch): retune to the target PCI, take the new C-RNTI, run
            # contention-free RA, then confirm on the TARGET's DCCH via
            # handover_complete().
            assert self.state == RrcState.CONNECTED
            mci = decode_message(msg.mobility)
            assert isinstance(mci, MobilityControlInfo)
            self._pending_ho = (msg.transaction_id, mci)
            self.n_id_cell = mci.target_pci
            self.crnti = mci.new_crnti
            return None
        if isinstance(msg, RrcConnectionReconfiguration):
            assert self.state == RrcState.CONNECTED
            self.dedicated = apply_dedicated(self._setup, self.common, msg)
            return RrcConnectionReconfigurationComplete(
                transaction_id=msg.transaction_id).pack()
        if isinstance(msg, RrcConnectionRelease):
            self.state = RrcState.IDLE_READY
            self.crnti = None
            return None
        raise ValueError(f"unexpected DCCH message {msg}")

    # ---------------------------------------------------------- handover --
    @property
    def pending_handover(self) -> MobilityControlInfo | None:
        ho = getattr(self, "_pending_ho", None)
        return ho[1] if ho else None

    def handover_complete(self) -> bytes:
        """After contention-free RA to the target succeeded: the
        ReconfigurationComplete for the target's DCCH."""
        tid, _ = self._pending_ho
        self._pending_ho = None
        return RrcConnectionReconfigurationComplete(
            transaction_id=tid).pack()

    # ------------------------------------------------------------ timers --
    def tick(self) -> str | None:
        """One TTI. Returns 'retry_ra' when T300 expires (rrc_UE restarts
        the RA procedure, ra_failed parity)."""
        if self._t300 is not None:
            self._t300 -= 1
            if self._t300 <= 0:
                self._t300 = None
                self.state = RrcState.IDLE_READY
                return "retry_ra"
        return None
