"""oaisim equivalent: N-eNB x M-UE system emulation without radio hardware
(counterpart of openair4g_tpu/sim/oaisim.py).

Reference parity: targets/SIMU/USER/oaisim.c (per-slot loop: MAC scheduler
-> phy_procedures_eNB_lte / phy_procedures_UE_lte, then do_DL_sig channel
coupling, channel_sim.c:81), with the two fidelity modes of the reference:
  * abstraction mode (-a): freq_channel -> compute_sinr (abstraction.c:190)
    -> EESM effective SINR -> BLER table -> coin flip (dlsch_decoding.c:524)
  * full PHY mode: bit-level TX/RX through the superposition of all
    eNB->UE links (multipath_channel coupling of every pair)
plus OMG-style mobility (random walk) and OTG-style traffic (full buffer /
on-off), and a round-robin MAC allocator standing in for
eNB_dlsch_ulsch_scheduler.

The UE axis is the batch axis: one TTI advances every UE of every cell at
once on the sim's device (the per-link fading taps ride a [n_ue * n_enb]
tensor, SINR/ESM/BLER are elementwise, the full-PHY receiver runs over
all UEs for each eNB). Mobility, scheduling, HARQ bookkeeping, the UL MAC
and handover are host-side, in the reference's order of numpy draws.

Each downlink TTI takes its draws injected (TtiDraws: the links' tap
normals, and the coin-flip uniforms or the fresh TB bits and the UEs'
noise normals), so it replays another generator's draws; run_frames draws
them from a torch.Generator seeded with cfg.seed on the sim's device.
The fade is drawn afresh every TTI (forgetting factor 0), as the
reference's ChannelModel default gives it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import FrameParms
from ..convert import wiener_stack_from_reference
from ..device import resolve_device
from ..ops.llr import demap_llr, map_symbols
from ..phy.channel_est import estimate_channel, make_wiener_stack
from ..phy.resource_grid import fill_grid, make_grid_map
from ..tables.tbs import get_TBS_DL, get_Qm
from .abstraction import BlerTable, draw_block_errors, eesm, miesm
from .channels import ChannelModel

# EESM beta calibration per modulation order (tunable; the reference
# carries per-MCS beta1/beta2 tables in dlsch_decoding.c:524+)
EESM_BETA = {2: 1.6, 4: 5.0, 6: 18.0}

# Coarse AWGN BLER anchors (SNR dB at BLER 0.5 / 0.1 / 0.01) from
# BASELINE.md's reference-curve extraction; calibrate_bler_table() produces
# exact curves from this framework's own dlsim when fidelity matters.
_BLER_ANCHORS = {
    0: (-2.8, -2.3, 0.3),
    4: (0.2, 0.6, 3.1),
    10: (4.8, 5.3, 9.1),
    17: (9.7, 10.2, 11.3),
    25: (15.6, 16.0, 16.3),
}

# The reference's ChannelModel.forgetting_factor default, which its oaisim
# keeps (evolve_taps without a factor): a fresh fade every TTI.
_FF = 0.0


@functools.lru_cache(maxsize=None)
def calibrated_bler_table(mcs: int, n_rb: int = 25, n_frames: int = 512,
                          snr_span_db: float = 3.0, n_pts: int = 9,
                          batch: int = 128, device=None) -> BlerTable:
    """Calibrate the abstraction's per-MCS BLER table by running the
    bit-level AWGN link sim around the waterfall (the reference's
    AWGN_results corpus generation feeding dlsch_abstraction_EESM's
    beta-calibrated tables, dlsch_decoding.c:543). Centered on the
    anchor-model knee, sampled at n_pts points over +-snr_span_db/2, on
    `device` (None: the card)."""
    from .dlsim import DlsimAwgn, DlsimConfig
    from .abstraction import calibrate_bler_table
    anchor = default_bler_table(mcs)
    knee = float(np.interp(np.log(0.5), anchor.log_bler[::-1],
                           anchor.snr_db[::-1]))
    snrs = np.linspace(knee - snr_span_db / 2, knee + snr_span_db / 2,
                       n_pts)
    sim = DlsimAwgn(DlsimConfig(mcs=mcs, n_rb=n_rb, batch=batch), device)
    return calibrate_bler_table(sim, snrs, n_frames)


def default_bler_table(mcs: int) -> BlerTable:
    """Piecewise curve through the nearest anchor MCS (shifted by the
    spectral-efficiency delta); good enough for system-level emulation."""
    anchors = sorted(_BLER_ANCHORS)
    near = min(anchors, key=lambda a: abs(a - mcs))
    s50, s10, s01 = _BLER_ANCHORS[near]
    shift = 0.8 * (mcs - near)       # ~0.8 dB per MCS step within a band
    snr = np.array([s50 - 3, s50, s10, s01, s01 + 2]) + shift
    bler = np.array([1.0, 0.5, 0.1, 0.01, 1e-4])
    return BlerTable(snr, bler)


@dataclass(frozen=True)
class OaisimConfig:
    """The reference's OaisimConfig fields and defaults, plus
    decoder_window (full-PHY mode; None: 96 on the CPU, 240 on a card)."""
    n_enb: int = 2
    n_ue: int = 8
    n_rb: int = 25
    mcs: int = 4
    channel: str = "EPA"
    mode: str = "abstraction"        # "abstraction" | "phy"
    esm: str = "eesm"                # effective-SINR map: "eesm" | "miesm"
    tx_power_db: float = 0.0         # eNB TX power over noise at d_ref
    pathloss_exp: float = 3.5
    d_ref: float = 100.0             # distance with 0 dB pathloss
    cell_spacing: float = 500.0
    speed_mps: float = 1.0
    mobility: str = "rwalk"          # OMG model: "rwalk" | "rwp" (random
    #   waypoint: pick a uniform destination, move at speed, repick on
    #   arrival — openair2/UTIL/OMG parity) | "static"
    traffic: str = "full"            # OTG model: "full" | "onoff" | "cbr"
    #   (fixed-size packet every cbr_period_tti) | "poisson" (exponential
    #   interarrival, mean 1/onoff_p per TTI) — openair2/UTIL/OTG parity
    onoff_p: float = 0.5
    cbr_period_tti: int = 4
    mac: str = "rr"                  # "rr" round-robin | "pf" prop-fair
    ul_traffic: bool = False         # enable the uplink MAC pass
    ul_arrival_p: float = 0.1        # per-UE per-TTI UL arrival probability
    ul_bytes: int = 600              # bytes per UL arrival
    ul_mcs: int = 10
    ul_tx_power_db: float = 30.0     # UE TX power over noise at d_ref
    n_turbo_iter: int = 6
    n_harq_rounds: int = 1           # >1 enables HARQ in the emulator loop
    duplex: str = "fdd"              # "fdd" | "tdd" (frame structure 2:
    #   DL scheduling only on D subframes, UL pass only on U subframes,
    #   per the 36.211 Table 4.2-2 direction mask — the reference's
    #   subframe_select gating in phy_procedures_lte_common.c)
    tdd_config: int = 1
    handover: bool = False           # RRC-level serving cell + A3-triggered
    #   X2 handover (rrc/handover.py ladder) instead of geometric argmax
    a3_offset_db: float = 3.0
    a3_hysteresis_db: float = 1.0
    a3_ttt_frames: int = 2           # time-to-trigger, in 10 ms frames
    seed: int = 0
    decoder_window: int | None = None

    @staticmethod
    def from_scenario(sc: dict) -> "OaisimConfig":
        """OCG-style scenario dict -> config (the reference's XML scenario
        files, openair2/UTIL/OCG/OCG_parse_XML.c, carried as JSON here).

        Sections mirror OCG: topology / channel / application / emulation."""
        topo = sc.get("topology", {})
        chan = sc.get("channel", {})
        app = sc.get("application", {})
        emu = sc.get("emulation", {})
        return OaisimConfig(
            n_enb=topo.get("n_enb", 2), n_ue=topo.get("n_ue", 8),
            cell_spacing=topo.get("cell_spacing_m", 500.0),
            speed_mps=topo.get("ue_speed_mps", 1.0),
            n_rb=chan.get("n_rb", 25), mcs=chan.get("mcs", 4),
            channel=chan.get("model", "EPA"),
            tx_power_db=chan.get("tx_power_db", 0.0),
            pathloss_exp=chan.get("pathloss_exponent", 3.5),
            traffic=app.get("traffic", "full"),
            onoff_p=app.get("onoff_p", 0.5),
            cbr_period_tti=app.get("cbr_period_tti", 4),
            mobility=topo.get("mobility", "rwalk"),
            mode=emu.get("mode", "abstraction"),
            esm=emu.get("esm", "eesm"),
            mac=emu.get("mac", "rr"),
            handover=emu.get("handover", False),
            duplex=emu.get("duplex", "fdd"),
            tdd_config=emu.get("tdd_config", 1),
            ul_traffic=app.get("ul_traffic", False),
            ul_arrival_p=app.get("ul_arrival_p", 0.1),
            ul_bytes=app.get("ul_bytes", 600),
            n_harq_rounds=emu.get("n_harq_rounds", 1),
            seed=emu.get("seed", 0))


def run_scenario(path_or_dict, n_frames: int | None = None,
                 device=None) -> dict:
    """Run an OCG-style JSON scenario file (or dict) end to end on
    `device` (None: the card)."""
    import json
    sc = path_or_dict
    if not isinstance(sc, dict):
        with open(sc) as f:
            sc = json.load(f)
    sim = Oaisim(OaisimConfig.from_scenario(sc), device=device)
    frames = n_frames or sc.get("emulation", {}).get("n_frames", 10)
    return sim.run_frames(frames)


class TtiDraws(NamedTuple):
    """The draws of one downlink TTI."""
    tap_normals: object        # ChannelModel.draw_normals(n_ue * n_enb)
    uniforms: torch.Tensor | None = None   # [U] coin flips (abstraction)
    tb_bits: torch.Tensor | None = None    # [E, TBS] fresh TB bits (phy)
    noise: torch.Tensor | None = None      # [U, nsym, n_fft, 2] (phy)


class Oaisim:
    """System emulator: frames of 10 TTIs, host mobility/scheduling,
    device PHY (abstraction or bit-level) on `device` (None: the card).

    Observability (openair2/UTIL/OPT + LOG parity): `pcap_path` captures
    each scheduled TTI's MAC TB via utils/opt (bit-level TB bytes in phy
    mode; an outcome record in abstraction mode), and the loop emits
    LOG_I/LOG_D lines through utils/log (enable with
    set_comp_log("SIM"/"MAC", "debug"))."""

    def __init__(self, cfg: OaisimConfig, bler_table: BlerTable | None = None,
                 pcap_path: str | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pcap = None
        if pcap_path is not None:
            from ..utils.opt import PcapWriter
            self.pcap = PcapWriter(pcap_path)
        self.fp = FrameParms(n_rb=cfg.n_rb)
        self.tbs = get_TBS_DL(cfg.mcs, cfg.n_rb)
        self.Qm = get_Qm(cfg.mcs)
        self.beta = EESM_BETA[self.Qm]
        self.table = bler_table or default_bler_table(cfg.mcs)
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp)
        self.rng = np.random.default_rng(cfg.seed)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

        # topology: eNBs on a line, UEs uniform in the deployment area
        self.enb_xy = np.stack([np.arange(cfg.n_enb) * cfg.cell_spacing,
                                np.zeros(cfg.n_enb)], axis=1)
        span = max(cfg.cell_spacing * cfg.n_enb, cfg.cell_spacing)
        self.ue_xy = np.stack([
            self.rng.uniform(-cfg.cell_spacing / 2, span, cfg.n_ue),
            self.rng.uniform(-cfg.cell_spacing / 2, cfg.cell_spacing / 2,
                             cfg.n_ue)], axis=1)
        self._update_links()

        # per-link fading state [n_ue * n_enb, taps]
        self.taps = self.chan.draw_taps(cfg.n_ue * cfg.n_enb,
                                        generator=self.gen,
                                        device=self.device)
        # RB-center frequency offsets for the SINR grid
        self.f_rb = tuple((np.arange(cfg.n_rb) * 12 + 6 - 6 * cfg.n_rb
                           ).tolist())
        if cfg.mode == "phy":
            self._init_phy_mode()
        self.stats = dict(tb_sent=np.zeros(cfg.n_ue, np.int64),
                          tb_err=np.zeros(cfg.n_ue, np.int64),
                          bits_ok=np.zeros(cfg.n_ue, np.int64),
                          retx=np.zeros(cfg.n_ue, np.int64))
        self._frame = 0
        if cfg.duplex == "tdd":
            from ..phy.tdd import TDD_PATTERNS
            self._tdd_pattern = TDD_PATTERNS[cfg.tdd_config]
        else:
            self._tdd_pattern = None
        if cfg.handover:
            self._init_handover()
        # HARQ state (abstraction: accumulated effective SINR = chase
        # combining; phy: per-eNB soft buffers carried across TTIs)
        self.harq_round = np.zeros(cfg.n_ue, np.int32)
        self.harq_pending = np.zeros(cfg.n_ue, bool)
        self.acc_eff = np.zeros(cfg.n_ue, np.float32)
        if cfg.ul_traffic:
            self._init_ul_mac()

    # ------------------------------------------------------------ UL MAC --
    def _init_ul_mac(self):
        """Uplink MAC pass: per-UE UeMac (BSR/PHR + UL HARQ entity) and a
        per-eNB multi-UE UlScheduler (schedule_ulsch parity) — the UL side
        of eNB_dlsch_ulsch_scheduler the reference runs every TTI."""
        from ..mac.ue_mac import UeMac, UeUlHarqEntity, unpack_short_bsr, \
            unpack_long_bsr
        from ..mac.ul_scheduler import UlScheduler, UlUeState
        cfg = self.cfg
        self._ue_mac = [UeMac(periodic_bsr_sf=5) for _ in range(cfg.n_ue)]
        self._ue_ulharq = [UeUlHarqEntity() for _ in range(cfg.n_ue)]
        self._ul_sched = [UlScheduler(n_rb_ul=cfg.n_rb, n_cce_max=8)
                          for _ in range(cfg.n_enb)]
        self._ul_state = [UlUeState(rnti=u, mcs=cfg.ul_mcs)
                          for u in range(cfg.n_ue)]
        from ..tables.tbs import get_TBS_UL
        self._get_tbs_ul = get_TBS_UL
        self._unpack_bsr = (unpack_short_bsr, unpack_long_bsr)
        self.stats.update(ul_tb_ok=np.zeros(cfg.n_ue, np.int64),
                          ul_tb_err=np.zeros(cfg.n_ue, np.int64),
                          ul_bytes_ok=np.zeros(cfg.n_ue, np.int64))

    def _ul_tti(self, tti: int):
        """One uplink TTI: traffic -> BSR CEs -> per-eNB schedule_ulsch ->
        abstraction-mode PUSCH outcome -> HARQ bookkeeping (host-side, as
        in the reference)."""
        cfg = self.cfg
        unpack_short, unpack_long = self._unpack_bsr
        pid = tti % 8
        for u in range(cfg.n_ue):
            if self.rng.random() < cfg.ul_arrival_p:
                self._ue_mac[u].offer_data(0, cfg.ul_bytes)
            self._ue_mac[u].tick()
            for lcid, ce in self._ue_mac[u].pending_ces():
                if lcid == 0x1D:
                    self._ul_state[u].buffer_bytes = unpack_short(ce)[1]
                elif lcid == 0x1E:
                    self._ul_state[u].buffer_bytes = sum(unpack_long(ce))
        # uplink geometry: reuse the DL pathloss, UE TX power; interference
        # comes from co-scheduled UEs in OTHER cells (host-level SINR)
        granted = []
        for e in range(cfg.n_enb):
            cell_ues = [self._ul_state[u] for u in range(cfg.n_ue)
                        if self.serving[u] == e]
            if cell_ues:    # round-robin rotation for multi-UE fairness
                rot = tti % len(cell_ues)
                cell_ues = cell_ues[rot:] + cell_ues[:rot]
            for g in self._ul_sched[e].schedule(cell_ues, pid=pid):
                granted.append((e, g))
        gain = self.p_rx * 10.0 ** ((cfg.ul_tx_power_db - cfg.tx_power_db)
                                    / 10.0)            # [U, E] UL link gain
        tx_ues = [g.rnti for _, g in granted]
        for e, g in granted:
            u = g.rnti
            sig = gain[u, e]
            intf = sum(gain[v, e] for v in tx_ues
                       if v != u and self.serving[v] != e)
            sinr = sig / (intf + 1.0)
            # chase combining across rounds: effective SINR adds
            sinr_eff = sinr * (1 + self._ul_state[u].retx_round)
            bler = float(np.exp(np.interp(
                10 * np.log10(max(sinr_eff, 1e-30)), self.table.snr_db,
                self.table.log_bler, left=0.0,
                right=self.table.log_bler[-1])))
            self._ue_ulharq[u].on_grant(pid, g.ndi, b"")
            crc_ok = bool(self.rng.random() > bler)
            self._ul_sched[e].on_pusch_result(self._ul_state[u], g, crc_ok)
            if crc_ok:                                 # TB completes
                self._ue_ulharq[u].on_ack(pid)
                self.stats["ul_tb_ok"][u] += 1
                nbytes = self._get_tbs_ul(g.mcs, g.n_prb) // 8
                self._ue_mac[u].consume(nbytes)
                self.stats["ul_bytes_ok"][u] += nbytes
            elif self._ul_state[u].retx_round == 0:
                self.stats["ul_tb_err"][u] += 1       # lost after max rounds

    # ----------------------------------------------------------- handover --
    def _init_handover(self):
        """RRC entities per node: the UE's serving cell is now RRC state
        changed only by the rrc/handover.py ladder (rrc_eNB.c:1760-1990),
        not by the geometric argmax. UEs start CONNECTED at their best
        cell."""
        from ..rrc.enb import RrcEnb, EnbUeContext, UeState
        from ..rrc.ue import RrcUe, RrcState
        cfg = self.cfg
        self.rrc_enbs = [RrcEnb() for _ in range(cfg.n_enb)]
        self.rrc_ues = []
        self.serving_rrc = self.serving.copy()
        self._a3_count = np.zeros(cfg.n_ue, np.int32)
        self.ho_events: list = []
        for u in range(cfg.n_ue):
            e = int(self.serving_rrc[u])
            ue = RrcUe(seed=cfg.seed * 1000 + u)
            ue.state = RrcState.CONNECTED
            ue.n_id_cell = e
            enb = self.rrc_enbs[e]
            crnti = enb._next_crnti
            enb._next_crnti += 1
            enb.ues[crnti] = EnbUeContext(crnti=crnti,
                                          ue_identity=ue.ue_identity,
                                          state=UeState.CONNECTED)
            ue.crnti = crnti
            self.rrc_ues.append(ue)

    def _a3_step(self):
        """Per-frame measurement + A3 evaluation + HO execution (the
        reference's per-frame RRC measurement processing in oaisim)."""
        from ..rrc.enb import RrcEnb
        from ..rrc.messages import MeasurementReport
        from ..rrc.handover import execute_handover
        cfg = self.cfg
        rsrp_code = np.clip(np.round(10 * np.log10(
            np.maximum(self.p_rx, 1e-12))) + 100, 0, 97).astype(int)
        for u in range(cfg.n_ue):
            s = int(self.serving_rrc[u])
            neigh = [(rsrp_code[u, e], e) for e in range(cfg.n_enb)
                     if e != s]
            if not neigh:
                return
            best_rsrp, best = max(neigh)
            if RrcEnb.a3_event(rsrp_code[u, s], best_rsrp,
                               cfg.a3_offset_db, cfg.a3_hysteresis_db):
                self._a3_count[u] += 1
            else:
                self._a3_count[u] = 0
                continue
            if self._a3_count[u] < cfg.a3_ttt_frames:
                continue
            self._a3_count[u] = 0
            report = MeasurementReport(
                meas_id=1, rsrp_serving=rsrp_code[u, s],
                neighbour_pci=best, rsrp_neighbour=best_rsrp)
            res = execute_handover(self.rrc_enbs[s], self.rrc_enbs[best],
                                   self.rrc_ues[u], report,
                                   target_pci=best)
            self.serving_rrc[u] = best
            self.ho_events.append(dict(frame=self._frame, ue=u,
                                       source=s, target=best,
                                       crnti=res.target_crnti))

    # ----------------------------------------------------------- topology --
    def _update_links(self):
        cfg = self.cfg
        d = np.linalg.norm(self.ue_xy[:, None, :] - self.enb_xy[None, :, :],
                           axis=-1)
        d = np.maximum(d, 10.0)
        pl_db = 10.0 * cfg.pathloss_exp * np.log10(d / cfg.d_ref)
        self.p_rx = 10.0 ** ((cfg.tx_power_db - pl_db) / 10.0)  # [U, E]
        if cfg.handover and hasattr(self, "serving_rrc"):
            self.serving = self.serving_rrc.copy()   # RRC decides, not
            #   geometry: cells change only through the HO ladder
        else:
            self.serving = np.argmax(self.p_rx, axis=1)          # [U]

    def _mobility_step(self):
        """OMG mobility, one frame (10 ms): random walk (default), random
        waypoint, or static (openair2/UTIL/OMG model set)."""
        cfg = self.cfg
        step = cfg.speed_mps * 0.01
        if cfg.mobility == "static":
            return
        if cfg.mobility == "rwp":
            if not hasattr(self, "_wp"):
                span = max(cfg.cell_spacing * cfg.n_enb, cfg.cell_spacing)
                self._wp_box = (-cfg.cell_spacing / 2, span,
                                -cfg.cell_spacing / 2, cfg.cell_spacing / 2)
                self._wp = self._draw_waypoints()
            d = self._wp - self.ue_xy
            dist = np.linalg.norm(d, axis=1, keepdims=True)
            arrived = dist[:, 0] < step
            move = np.minimum(dist, step)
            self.ue_xy += d / np.maximum(dist, 1e-9) * move
            if arrived.any():
                new_wp = self._draw_waypoints()
                self._wp[arrived] = new_wp[arrived]
        else:
            self.ue_xy += self.rng.normal(0, step, self.ue_xy.shape)
        self._update_links()

    def _draw_waypoints(self):
        x0, x1, y0, y1 = self._wp_box
        return np.stack([self.rng.uniform(x0, x1, self.cfg.n_ue),
                         self.rng.uniform(y0, y1, self.cfg.n_ue)], axis=1)

    def _schedule(self, tti: int) -> np.ndarray:
        """MAC allocation: round-robin or proportional-fair (mac/scheduler).
        Returns mask [n_ue] of scheduled UEs."""
        cfg = self.cfg
        mask = np.zeros(cfg.n_ue, bool)
        if cfg.traffic == "onoff":
            active = self.rng.random(cfg.n_ue) < cfg.onoff_p
        elif cfg.traffic == "cbr":
            # constant bit rate: a packet becomes ready every period
            active = (tti + np.arange(cfg.n_ue)) % cfg.cbr_period_tti == 0
        elif cfg.traffic == "poisson":
            if not hasattr(self, "_next_arrival"):
                self._next_arrival = self.rng.exponential(
                    1.0 / max(cfg.onoff_p, 1e-6), cfg.n_ue)
            self._next_arrival -= 1.0
            active = self._next_arrival <= 0
            self._next_arrival[active] = self.rng.exponential(
                1.0 / max(cfg.onoff_p, 1e-6), int(active.sum()))
        else:
            active = np.ones(cfg.n_ue, bool)
        if cfg.mac == "pf":
            if not hasattr(self, "_pf"):
                from ..mac import PfScheduler, UeContext
                self._pf = PfScheduler(cfg.n_rb, max_ues_per_tti=1)
                self._ue_ctx = [UeContext(rnti=u) for u in range(cfg.n_ue)]
            # per-UE wideband CQI from the geometry SINR (host estimate)
            sig = self.p_rx[np.arange(cfg.n_ue), self.serving]
            intf = self.p_rx.sum(1) - sig
            sinr_db = 10 * np.log10(np.maximum(sig / (intf + 1.0), 1e-9))
            for u, ctx in enumerate(self._ue_ctx):
                ctx.cqi = int(np.clip(round(sinr_db[u] / 2 + 3), 1, 15))
                ctx.drx = not bool(active[u])
                ctx.pending_retx = bool(self.harq_pending[u])
                ctx.retx_rv = 0       # chase combining in the emulator
            for e in range(cfg.n_enb):
                cell = [self._ue_ctx[u] for u in range(cfg.n_ue)
                        if self.serving[u] == e]
                for a in self._pf.schedule(cell, tti):
                    mask[a.rnti] = True
            return mask
        for e in range(cfg.n_enb):
            ues = np.nonzero((self.serving == e) & active)[0]
            if not len(ues):
                continue
            # HARQ retransmissions keep the grant (reference pass-1 rule)
            retx = ues[self.harq_pending[ues]]
            mask[retx[0] if len(retx) else ues[tti % len(ues)]] = True
        return mask

    # -------------------------------------------------------------- draws --
    def draw(self) -> TtiDraws:
        """One downlink TTI's draws from self.gen on the sim's device."""
        cfg, dev, gen = self.cfg, self.device, self.gen
        U, E = cfg.n_ue, cfg.n_enb
        normals = self.chan.draw_normals(U * E, gen, dev)
        if cfg.mode == "abstraction":
            return TtiDraws(normals, uniforms=torch.rand(
                U, generator=gen, device=dev))
        tb = torch.randint(0, 2, (E, self.tbs), generator=gen, device=dev,
                           dtype=torch.int32)
        noise = torch.randn(U, self.fp.symbols_per_subframe, self.fp.n_fft,
                            2, generator=gen, device=dev)
        return TtiDraws(normals, tb_bits=tb, noise=noise)

    # ----------------------------------------------- abstraction-mode TTI --
    def _tti_abs(self, draws: TtiDraws, p_rx, serving_onehot, sched):
        """One abstraction-mode TTI for all UEs.

        p_rx [U, E] and serving_onehot [U, E] float32 on the device; sched
        [U] bool (host). Chase combining adds the accumulated effective
        SINR of the pending HARQ process (self.acc_eff, 0 for new TBs).
        Returns (err [U] bool, eff_combined [U]) on the host."""
        cfg, dev = self.cfg, self.device
        U, E = cfg.n_ue, cfg.n_enb
        taps = self.taps = self.chan.evolve_taps(self.taps,
                                                 draws.tap_normals, _FF)
        H = self.chan.freq_response_at(taps, self.f_rb)      # [U*E, n_rb]
        g = (H.abs() ** 2).reshape(U, E, -1) * p_rx[:, :, None]
        sig = torch.sum(serving_onehot[:, :, None] * g, dim=1)
        intf = torch.sum(g, dim=1) - sig
        sinr = sig / (intf + 1.0)                            # n0 = 1
        acc = torch.as_tensor(self.acc_eff, device=dev)
        if cfg.esm == "miesm":
            eff = miesm(sinr, self.Qm) + acc                 # [U] combined
        else:
            eff = eesm(sinr, self.beta) + acc
        bler = self.table.lookup(eff)
        err = draw_block_errors(draws.uniforms, bler)        # one vector
        err = err & torch.as_tensor(sched, device=dev)
        return err.cpu().numpy(), eff.cpu().numpy()

    # ------------------------------------------------------- PHY-mode TTI --
    def _init_phy_mode(self):
        from ..phy.pdsch import DlschCodec, DlschConfig
        cfg, dev = self.cfg, self.device
        self.codec = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb, n_pdcch_symbols=1,
            n_turbo_iter=cfg.n_turbo_iter,
            decoder_window=cfg.decoder_window))
        # per-eNB grid maps (distinct cell IDs -> distinct pilots)
        self.gms = [make_grid_map(cfg.n_rb, 1, e, subframe=7)
                    for e in range(cfg.n_enb)]
        # noise floor is 1.0 by construction; time_avg -> n0/4 prior
        self.wieners = [wiener_stack_from_reference(
            make_wiener_stack(gm, 0.25), dev) for gm in self.gms]
        self._bins = torch.as_tensor(self.fp.sc_to_bin(
            np.arange(self.fp.n_sc)), dtype=torch.long, device=dev)
        self._f_all = tuple((np.arange(self.fp.n_sc)
                             - 6 * self.fp.n_rb).tolist())
        self._data_idx = [tuple(torch.as_tensor(a, dtype=torch.long,
                                                device=dev)
                                for a in (gm.data_sym, gm.data_bin,
                                          gm.data_sc))
                          for gm in self.gms]
        # HARQ: per-eNB persistent TB + per-(eNB, UE) soft buffers, plus
        # which UE each eNB's open process is bound to (-1 = none)
        U, E = cfg.n_ue, cfg.n_enb
        self._phy_tb = torch.zeros(E, self.tbs, dtype=torch.int32,
                                   device=dev)
        self._phy_wsoft = [
            [torch.zeros(U, m.L, dtype=torch.float32, device=dev)
             for m in self.codec.maps]
            for _ in range(E)]
        self._phy_bound = np.full(E, -1, np.int32)

    def _couple(self, taps, p_rx, grids, noise):
        """Every UE's received grid [U, nsym, n_fft]: the sum over eNBs of
        the eNB's grid [E, nsym, n_fft] through the UE's link (do_DL_sig's
        all-pairs convolution, as per-subcarrier multiplies), plus unit-
        variance noise from the normals [U, nsym, n_fft, 2]."""
        U, E = self.cfg.n_ue, self.cfg.n_enb
        Hs = self.chan.freq_response_at(taps, self._f_all).reshape(U, E, -1)
        amp = torch.sqrt(p_rx)[:, :, None]
        gsub = grids[:, :, self._bins]                       # [E, nsym, sc]
        rx_occ = torch.einsum("uef,esf->usf", Hs * amp, gsub)
        rgrid = torch.zeros(U, self.fp.symbols_per_subframe, self.fp.n_fft,
                            dtype=torch.complex64, device=self.device)
        rgrid[:, :, self._bins] = rx_occ
        nr = noise.to(self.device, torch.float32)
        return rgrid + float(np.sqrt(np.float32(0.5))) * torch.complex(
            nr[..., 0], nr[..., 1])

    def _tti_phy(self, draws: TtiDraws, p_rx, sched, clear):
        """Bit-level TTI: every eNB transmits a PDSCH subframe to its
        scheduled UE; every UE receives the superposition of all eNBs
        through its own per-link channels.

        HARQ (chase combining): self._phy_tb [E, TBS] is each eNB's open
        TB, self._phy_wsoft the per-(eNB, block) soft buffers [U, L],
        `clear` [E] 1.0 where a NEW TB starts (buffers zeroed, fresh bits)
        — harq_process->w with the round-0 clear flag
        (dlsch_decoding.c:360). Returns err [U] bool on the host."""
        cfg, dev = self.cfg, self.device
        U, E = cfg.n_ue, cfg.n_enb
        taps = self.taps = self.chan.evolve_taps(self.taps,
                                                 draws.tap_normals, _FF)

        # eNB TX: one TB per eNB; fresh bits where `clear`, else the open
        # HARQ process retransmits (chase)
        fresh = draws.tb_bits.to(dev, torch.int32)
        clear_t = torch.as_tensor(clear, device=dev)
        tb = torch.where(clear_t[:, None] > 0.5, fresh, self._phy_tb)
        wsoft = [[w * float(1.0 - clear[e]) for w in self._phy_wsoft[e]]
                 for e in range(E)]
        e_bits = self.codec.encode(tb)
        syms = map_symbols(e_bits, self.Qm)
        grids = torch.stack([fill_grid(syms[e:e + 1], self.gms[e])[0]
                             for e in range(E)])             # [E, 14, F]
        rgrid = self._couple(taps, p_rx, grids, draws.noise)

        # UE RX: serving-cell pilots -> CE -> equalize -> decode (with the
        # carried soft buffers: HARQ combining at every UE, the serving
        # one's entry is the meaningful one)
        errs, new_wsoft = [], []
        for e in range(E):
            sym, bins, sc = self._data_idx[e]
            H_hat = estimate_channel(rgrid, self.gms[e], self.wieners[e],
                                     time_avg=True)
            y = rgrid[:, sym, bins]
            h = H_hat[:, sym, sc]
            g = torch.clamp(h.abs() ** 2, min=1e-9)
            llr = demap_llr(y * torch.conj(h) / g, 1.0 / g,
                            self.Qm).reshape(U, -1)
            _, ok, w_new = self.codec.decode(llr, w_soft=wsoft[e])
            errs.append(~ok)                                 # [U]
            new_wsoft.append(w_new)
        err_by_serving = torch.stack(errs, dim=1)            # [U, E]
        serving = torch.as_tensor(self.serving, device=dev)
        err = torch.take_along_dim(err_by_serving, serving[:, None],
                                   dim=1)[:, 0]
        self._phy_tb, self._phy_wsoft = tb, new_wsoft
        return (err & torch.as_tensor(sched, device=dev)).cpu().numpy()

    # --------------------------------------------------------------- run --
    def run_frames(self, n_frames: int, draws=None):
        """Run n_frames frames and return summary(). `draws(abs_tti)`
        gives the TtiDraws of downlink TTI frame * 10 + tti (replayed
        draws); None draws them with self.draw()."""
        cfg, dev = self.cfg, self.device
        U, E = cfg.n_ue, cfg.n_enb
        draw = draws or (lambda abs_tti: self.draw())
        for f in range(n_frames):
            serving_onehot = np.zeros((U, E), np.float32)
            serving_onehot[np.arange(U), self.serving] = 1.0
            onehot_t = torch.as_tensor(serving_onehot, device=dev)
            p_rx_t = torch.as_tensor(self.p_rx, dtype=torch.float32,
                                     device=dev)
            for tti in range(10):
                # TDD gating: UL pass on U subframes, DL on D subframes
                # (S carries neither data direction in the emulator)
                direction = (self._tdd_pattern[tti % 10]
                             if self._tdd_pattern else None)
                if cfg.ul_traffic and direction in (None, "U"):
                    self._ul_tti(self._frame * 10 + tti)
                if direction in ("U", "S"):
                    self.stats.setdefault(
                        "tti_skipped_dl", 0)
                    self.stats["tti_skipped_dl"] += 1
                    continue
                sched = self._schedule(tti)
                d = draw(self._frame * 10 + tti)
                if cfg.mode == "abstraction":
                    err, eff = self._tti_abs(d, p_rx_t, onehot_t, sched)
                    self._trace_tti(tti, sched, err)
                    self._harq_update(sched, err, eff)
                else:
                    clear = self._phy_clear_mask(sched)
                    err = self._tti_phy(d, p_rx_t, sched, clear)
                    self._trace_tti(tti, sched, err,
                                    tb=self._phy_tb.cpu().numpy())
                    self._harq_update(sched, err, None)
            self._mobility_step()
            if cfg.handover:
                self._a3_step()
                self.serving = self.serving_rrc.copy()
            self._frame += 1
        return self.summary()

    def _trace_tti(self, tti: int, sched: np.ndarray, err: np.ndarray,
                   tb: np.ndarray | None = None) -> None:
        """OPT/LOG hook for one TTI: pcap record per scheduled UE + a
        debug log line (openair2/UTIL/OPT trace_pdu parity)."""
        from ..utils.log import LOG_D
        abs_tti = self._frame * 10 + tti
        for u in np.nonzero(sched)[0]:
            LOG_D("MAC", "tti=%d ue=%d cell=%d %s", abs_tti, u,
                  int(self.serving[u]), "NACK" if err[u] else "ACK")
            if self.pcap is None:
                continue
            from ..utils.opt import KIND_MAC, DIR_DL
            if tb is not None:      # bit-level TB bytes (phy mode)
                pdu = np.packbits(tb[int(self.serving[u])].astype(
                    np.uint8)).tobytes()
            else:                   # abstraction: outcome record
                pdu = bytes([int(err[u])]) + int(self.tbs).to_bytes(
                    4, "big")
            self.pcap.write(pdu, tti=abs_tti, direction=DIR_DL,
                            kind=KIND_MAC, rnti=int(u))

    def _phy_clear_mask(self, sched: np.ndarray) -> np.ndarray:
        """[E] 1.0 where the eNB starts a NEW TB this TTI: no open HARQ
        process, or the open process is bound to a different UE than the
        one scheduled now (rebinding drops the old process)."""
        cfg = self.cfg
        clear = np.ones(cfg.n_enb, np.float32)
        for e in range(cfg.n_enb):
            ues = np.nonzero(sched & (self.serving == e))[0]
            if not len(ues):
                continue
            u = int(ues[0])
            if self.harq_pending[u] and self._phy_bound[e] == u:
                clear[e] = 0.0
            self._phy_bound[e] = u
        return clear

    def _harq_update(self, sched: np.ndarray, err: np.ndarray,
                     eff: np.ndarray | None) -> None:
        """Host HARQ bookkeeping after one TTI (both modes).

        New TB when the UE had no pending process; on error the process
        stays open (chase combining) until n_harq_rounds, then the TB is
        lost — the reference's round/Mdlharq accounting
        (dlsch_decoding.c:455-476)."""
        R = self.cfg.n_harq_rounds
        for u in np.nonzero(sched)[0]:
            new_tb = not self.harq_pending[u]
            if new_tb:
                self.stats["tb_sent"][u] += 1
                self.harq_round[u] = 0
                self.acc_eff[u] = 0.0
            else:
                self.stats["retx"][u] += 1
            if not err[u]:
                self.stats["bits_ok"][u] += self.tbs
                self.harq_pending[u] = False
                self.acc_eff[u] = 0.0
                continue
            self.harq_round[u] += 1
            if self.harq_round[u] >= R:
                self.stats["tb_err"][u] += 1          # lost after R rounds
                self.harq_pending[u] = False
                self.acc_eff[u] = 0.0
            else:
                self.harq_pending[u] = True
                if eff is not None:
                    self.acc_eff[u] = eff[u]          # combined so far

    def summary(self) -> dict:
        sent = np.maximum(self.stats["tb_sent"], 1)
        per_ue_bler = self.stats["tb_err"] / sent
        thr = self.stats["bits_ok"] / max(self._frame * 0.01, 1e-9)
        out = dict(frames=self._frame,
                   per_ue_bler=per_ue_bler,
                   mean_bler=float(per_ue_bler.mean()),
                   sum_throughput_mbps=float(thr.sum() / 1e6),
                   retx_total=int(self.stats["retx"].sum()),
                   serving=self.serving.copy())
        if self.cfg.handover:
            out["ho_events"] = list(self.ho_events)
        if "ul_tb_ok" in self.stats:
            out["ul_tb_ok"] = self.stats["ul_tb_ok"].copy()
            out["ul_throughput_mbps"] = float(
                self.stats["ul_bytes_ok"].sum() * 8
                / max(self._frame * 0.01, 1e-9) / 1e6)
        return out
