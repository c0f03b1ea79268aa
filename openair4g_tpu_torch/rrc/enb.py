"""RRC eNB: SI broadcast scheduling + per-UE connection state machines.

Reference parity: openair2/RRC/LITE/rrc_eNB.c — rrc_eNB_decode_ccch
(connection request handling), rrc_eNB_generate_RRCConnectionSetup,
rrc_eNB_process_RRCConnectionSetupComplete,
rrc_eNB_generate_defaultRRCConnectionReconfiguration and the SI window
scheduling in openair2/LAYER2/MAC/eNB_scheduler_bch.c. Timing rules kept:
SIB1 on subframe 5 of even frames (80 ms repetition of the same segment),
SIB2 in its SI window per si_periodicity.

A copy of openair4g_tpu/rrc/enb.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from .messages import (Sib1, Sib2, RrcConnectionRequest,
                       RrcConnectionSetup, RrcConnectionSetupComplete,
                       RrcConnectionReconfiguration,
                       RrcConnectionReconfigurationComplete,
                       RrcConnectionRelease, MeasurementReport,
                       MobilityControlInfo, RrcHandoverCommand,
                       HandoverPreparationInformation,
                       SecurityModeCommand, SecurityModeComplete,
                       SecurityModeFailure, decode_message)


class UeState(Enum):
    INITIAL = 0
    WAIT_SETUP_COMPLETE = 1
    CONNECTED = 2
    WAIT_RECONF_COMPLETE = 3
    RELEASED = 4
    HANDOVER_PREP = 5        # source side: HO command sent, ctx doomed
    WAIT_HO_COMPLETE = 6     # target side: admitted, waiting for the UE


@dataclass
class EnbUeContext:
    crnti: int
    state: UeState = UeState.INITIAL
    ue_identity: int = 0
    transmission_mode: int = 1
    transaction_id: int = 0
    setup_tti: int = 0
    reports: list = field(default_factory=list)
    as_secured: bool = False     # SecurityModeComplete received


class RrcEnb:
    """One cell's RRC entity. Byte-message API: every handler takes/returns
    packed messages, so the transport is whatever the caller wires in
    (RLC-TM CCCH for Msg3/Msg4, RLC-AM DCCH afterwards)."""

    def __init__(self, sib1: Sib1 | None = None, sib2: Sib2 | None = None,
                 setup_timeout_ttis: int = 100):
        self.sib1 = sib1 or Sib1()
        self.sib2 = sib2 or Sib2()
        self.ues: dict[int, EnbUeContext] = {}
        self._next_crnti = 0x100
        self.setup_timeout = setup_timeout_ttis
        self.tti = 0

    # ------------------------------------------------------- SI broadcast --
    def bcch_schedule(self, sfn: int, subframe: int) -> bytes | None:
        """What (if anything) goes on BCCH-DLSCH this TTI.

        SIB1: subframe 5, even SFN (36.331 §5.2.1.2). SIB2: subframe 0 of
        the first frame of each SI window, period 2^(3+si_periodicity)
        frames."""
        if subframe == 5 and sfn % 2 == 0:
            return self.sib1.pack()
        period = 1 << (3 + self.sib1.si_periodicity)
        if subframe == 0 and sfn % period == 1:
            return self.sib2.pack()
        return None

    # ------------------------------------------------------- CCCH (SRB0) --
    def reserve_crnti(self) -> int:
        """Pre-allocate a C-RNTI at RAR time (the T-CRNTI the MAC promises
        in the RAR grant, 36.321 §5.1.4); pass it back to handle_ccch so
        Msg3 processing binds the same value even when several RA
        procedures are in flight."""
        crnti = self._next_crnti
        # wrap before the reserved space (RA-RNTI low range is <0x3D;
        # P/SI/M-RNTI live at 0xFFFD+): stay in [0x100, 0xFFF0)
        nxt = self._next_crnti + 1
        self._next_crnti = 0x100 if nxt >= 0xFFF0 else nxt
        return crnti

    def handle_ccch(self, msg3: bytes,
                    crnti: int | None = None) -> tuple[int, bytes]:
        """RRCConnectionRequest -> allocate C-RNTI, return (crnti, Msg4).

        The Msg4 RRCConnectionSetup echoes the 40-bit UE identity — the
        MAC contention-resolution rule (36.321 §5.1.5) rides on that."""
        req = decode_message(msg3)
        assert isinstance(req, RrcConnectionRequest), req
        if crnti is None:
            crnti = self.reserve_crnti()
        ctx = EnbUeContext(crnti=crnti, ue_identity=req.ue_identity,
                           state=UeState.WAIT_SETUP_COMPLETE,
                           setup_tti=self.tti)
        self.ues[crnti] = ctx
        from ..utils.log import LOG_I
        LOG_I("RRC", "ConnectionRequest id=%x -> C-RNTI %#x",
              req.ue_identity, crnti)
        setup = RrcConnectionSetup(ue_identity=req.ue_identity)
        return crnti, setup.pack()

    # ------------------------------------------------------- DCCH (SRB1) --
    def handle_dcch(self, crnti: int, data: bytes) -> bytes | None:
        """Uplink DCCH message from a connected UE -> optional response."""
        ctx = self.ues[crnti]
        msg = decode_message(data)
        if isinstance(msg, RrcConnectionSetupComplete):
            assert ctx.state == UeState.WAIT_SETUP_COMPLETE, ctx.state
            ctx.state = UeState.CONNECTED
            return None
        if isinstance(msg, RrcConnectionReconfigurationComplete):
            assert ctx.state in (UeState.WAIT_RECONF_COMPLETE,
                                 UeState.WAIT_HO_COMPLETE), ctx.state
            assert msg.transaction_id == ctx.transaction_id
            ctx.state = UeState.CONNECTED
            return None
        if isinstance(msg, MeasurementReport):
            ctx.reports.append(msg)
            return None
        if isinstance(msg, SecurityModeComplete):
            ctx.as_secured = True
            from ..utils.log import LOG_I
            LOG_I("RRC", "C-RNTI %#x AS security activated", crnti)
            return None
        if isinstance(msg, SecurityModeFailure):
            from ..utils.log import LOG_W
            LOG_W("RRC", "C-RNTI %#x SecurityModeFailure", crnti)
            return None
        raise ValueError(f"unexpected DCCH message {msg}")

    def security_mode_command(self, crnti: int) -> bytes:
        """Build the AS SecurityModeCommand for a connected UE
        (rrc_eNB_generate_SecurityModeCommand). The caller activates its
        SRB1 PDCP TX integrity with K_RRCint so this very message carries
        the first valid MAC-I."""
        ctx = self.ues[crnti]
        assert ctx.state == UeState.CONNECTED, ctx.state
        return SecurityModeCommand().pack()

    def reconfigure(self, crnti: int, transmission_mode: int | None = None,
                    srs_enable: bool = False, meas_enable: bool = False,
                    drb_add: bool = False) -> bytes:
        """Build + arm an RRCConnectionReconfiguration for one UE."""
        ctx = self.ues[crnti]
        assert ctx.state == UeState.CONNECTED, ctx.state
        ctx.transaction_id = (ctx.transaction_id + 1) & 3
        tm = transmission_mode or ctx.transmission_mode
        ctx.transmission_mode = tm
        ctx.state = UeState.WAIT_RECONF_COMPLETE
        return RrcConnectionReconfiguration(
            transaction_id=ctx.transaction_id, transmission_mode=tm,
            srs_enable=int(srs_enable), meas_enable=int(meas_enable),
            drb_add=int(drb_add)).pack()

    def release(self, crnti: int, cause: int = 1) -> bytes:
        self.ues[crnti].state = UeState.RELEASED
        return RrcConnectionRelease(release_cause=cause).pack()

    # ---------------------------------------------------------- handover --
    @staticmethod
    def a3_event(rsrp_serving: int, rsrp_neighbour: int,
                 a3_offset_db: float = 3.0, hysteresis_db: float = 1.0
                 ) -> bool:
        """36.331 §5.5.4.4 A3 entering condition:
        Mn - Hys > Ms + Off (codes are 1 dB/step, 36.133)."""
        return rsrp_neighbour - hysteresis_db > rsrp_serving + a3_offset_db

    def build_handover_preparation(self, crnti: int,
                                   report: MeasurementReport) -> bytes:
        """Source side: MeasurementReport passed the A3 trigger -> build
        the inter-eNB HandoverPreparationInformation and mark the context
        (rrc_eNB_process_MeasurementReport -> HO prep,
        rrc_eNB.c:1760-1990)."""
        ctx = self.ues[crnti]
        assert ctx.state == UeState.CONNECTED, ctx.state
        ctx.state = UeState.HANDOVER_PREP
        return HandoverPreparationInformation(
            ue_identity=ctx.ue_identity, source_crnti=crnti,
            transmission_mode=ctx.transmission_mode,
            rsrp_neighbour=report.rsrp_neighbour).pack()

    def admit_handover(self, hpi_bytes: bytes, target_pci: int,
                       ra_preamble: int = 60) -> tuple[int, bytes]:
        """Target side: admit the incoming UE — allocate a C-RNTI + a
        dedicated (contention-free) RA preamble and build the
        RRCConnectionReconfiguration-with-mobilityControlInfo the source
        forwards to the UE. Returns (new_crnti, ho_command_bytes)."""
        hpi = decode_message(hpi_bytes)
        assert isinstance(hpi, HandoverPreparationInformation)
        crnti = self._next_crnti
        self._next_crnti = (self._next_crnti + 1) & 0xFFF0 or 0x100
        ctx = EnbUeContext(crnti=crnti, ue_identity=hpi.ue_identity,
                           transmission_mode=hpi.transmission_mode,
                           state=UeState.WAIT_HO_COMPLETE,
                           setup_tti=self.tti)
        ctx.transaction_id = 1
        self.ues[crnti] = ctx
        mci = MobilityControlInfo(target_pci=target_pci, new_crnti=crnti,
                                  ra_preamble_index=ra_preamble)
        return crnti, RrcHandoverCommand(transaction_id=1,
                                         mobility=mci.pack()).pack()

    def handover_complete_source(self, crnti: int) -> None:
        """Source side: the target confirmed — drop the old context
        (rrc_eNB release after HO)."""
        self.ues.pop(crnti, None)

    # ------------------------------------------------------------ timers --
    def tick(self) -> list[int]:
        """Advance one TTI; drop UEs stuck waiting for SetupComplete
        (the reference's rrc_eNB removes the context on T. expiry)."""
        self.tti += 1
        dropped = []
        for crnti, ctx in list(self.ues.items()):
            if (ctx.state == UeState.WAIT_SETUP_COMPLETE and
                    self.tti - ctx.setup_tti > self.setup_timeout):
                from ..utils.log import LOG_W
                LOG_W("RRC", "C-RNTI %#x setup timeout -> context dropped",
                      crnti)
                del self.ues[crnti]
                dropped.append(crnti)
        return dropped
