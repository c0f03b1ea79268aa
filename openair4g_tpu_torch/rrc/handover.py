"""X2-flavoured intra-MME handover ladder (36.331 §5.4.3, 36.413 §8.4.4).

Reference parity: openair2/RRC/LITE/rrc_eNB.c:1760-1990 —
rrc_eNB_process_MeasurementReport builds HandoverPreparationInformation,
the target generates RRCConnectionReconfiguration with
mobilityControlInfo (new C-RNTI + dedicated RA preamble), the UE performs
contention-free random access to the target and confirms with
ReconfigurationComplete; the target then path-switches the S1-U bearer
(openair-cn s1ap PathSwitchRequest -> SGW Modify Bearer).

One function drives the whole ladder between two RrcEnb instances, one
RrcUe and (optionally) the two EnbApp S1 endpoints, so sim/oaisim and the
tests execute the identical procedure.

A copy of openair4g_tpu/rrc/handover.py.
"""
from __future__ import annotations

from dataclasses import dataclass

from .enb import RrcEnb, UeState
from .ue import RrcUe
from .messages import MeasurementReport
from ..utils.log import LOG_I


@dataclass
class HandoverResult:
    source_crnti: int
    target_crnti: int
    target_pci: int
    ra_preamble: int
    path_switched: bool


def execute_handover(source: RrcEnb, target: RrcEnb, ue: RrcUe,
                     report: MeasurementReport, target_pci: int,
                     source_app=None, target_app=None,
                     ra_preamble: int = 60) -> HandoverResult:
    """Run the complete HO ladder. `source_app`/`target_app` are EnbApp
    S1 endpoints (None = no EPC attached, RRC-only handover)."""
    src_crnti = ue.crnti
    # 1. source decides from the report (A3 already passed by the caller)
    hpi = source.build_handover_preparation(src_crnti, report)
    # 2. target admits: new C-RNTI + dedicated preamble + HO command
    new_crnti, ho_cmd = target.admit_handover(hpi, target_pci,
                                              ra_preamble=ra_preamble)
    LOG_I("RRC", "HO prep: %#x@src -> %#x@pci%d", src_crnti, new_crnti,
          target_pci)
    # 3. source forwards the command on its DCCH; UE retunes
    assert ue.on_dcch(ho_cmd) is None
    mci = ue.pending_handover
    assert mci is not None and mci.new_crnti == new_crnti
    # 4. UE contention-free RA to the target with the dedicated preamble
    #    (ra_procedures.c: preamble from mobilityControlInfo, no Msg3
    #    contention). Modeled as the RAR-level exchange; the PHY preamble
    #    TX/detect path is exercised in sim/prachsim + sim/capstone.
    from ..mac.ra import RaProcedure, Rar
    ra = RaProcedure(preamble=mci.ra_preamble_index)
    ra.send_preamble()
    assert ra.on_rar(Rar(rapid=mci.ra_preamble_index, timing_advance=0,
                         ul_grant=0, t_crnti=new_crnti))
    # 5. UE confirms on the target DCCH
    target.handle_dcch(new_crnti, ue.handover_complete())
    assert target.ues[new_crnti].state == UeState.CONNECTED
    # 6. S1 path switch + source context cleanup
    path_switched = False
    if source_app is not None and target_app is not None:
        s1_ctx = source_app.handover_out(src_crnti)
        target_app.handover_in(new_crnti, s1_ctx)
        path_switched = True
    source.handover_complete_source(src_crnti)
    LOG_I("RRC", "HO complete: UE now %#x at pci%d (path_switched=%s)",
          new_crnti, target_pci, path_switched)
    return HandoverResult(source_crnti=src_crnti, target_crnti=new_crnti,
                          target_pci=target_pci, ra_preamble=ra_preamble,
                          path_switched=path_switched)
