"""TDD frame simulator (counterpart of openair4g_tpu/sim/tddsim.py): per-TTI
procedures driven by the UL/DL configuration masks, with a special
subframe (DwPTS / GP / UpPTS).

Reference parity: openair1/SCHED/phy_procedures_lte_common.c (the
subframe_select / direction masks gating phy_procedures_eNB_TX vs RX per
TTI in TDD), 36.211 §4.2 frame structure type 2 via phy/tdd.py, and the
special-subframe budget (DwPTS carries the control region, UpPTS carries
SRS: srs_modulation.c UpPTS handling).

One radio frame at a time: DL subframes run the full eNB-TX -> channel ->
UE-RX chain (sched/enb_tx + sched/ue_rx), UL subframes the UE-TX ->
eNB-RX chain (sched/ue_tx + sched/enb_rx), the special subframe transmits
only its DwPTS symbols downlink and an UpPTS SRS uplink. The direction
mask is authoritative: nothing is transmitted against it. The TBs come
from numpy's default_rng(seed); each subframe's noise normals are
injected (`run_frame(..., noise=...)`) or drawn on the simulator's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import device_plan, resolve_device
from ..ops.gold import scramble_bits
from ..ops.llr import map_symbols
from ..phy import ofdm
from ..phy.pdcch import pack_dci_format1a, unpack_dci_format1a
from ..phy.srs import SrsConfig, srs_bins, srs_estimate, srs_sequence
from ..phy.tdd import TDD_PATTERNS, direction_mask, special_symbols
from ..sched.enb_rx import EnbRx
from ..sched.enb_tx import CellConfig, EnbTx
from ..sched.ue_rx import UeRx
from ..sched.ue_tx import UeTx, UeUlConfig
from .dlsim import _noise


@dataclass(frozen=True)
class TddsimConfig:
    """The reference's TddsimConfig fields and defaults, plus
    decoder_window (None: 96 on the CPU, 240 on a card)."""
    tdd_config: int = 1          # 36.211 Table 4.2-2 (DSUUDDSUUD)
    ssf_config: int = 7          # Table 4.2-1 (DwPTS 10, GP 2, UpPTS 2)
    n_rb: int = 6
    mcs_dl: int = 4
    mcs_ul: int = 10
    n_pdcch: int = 3   # 1.4 MHz needs 3-4 control symbols for its CCEs
    rnti: int = 0x1234
    n_id_cell: int = 0
    batch: int = 8
    n_turbo_iter: int = 6
    decoder_window: int | None = None


def valid_pusch_rb(n: int) -> int:
    """Largest PUSCH allocation <= n whose size is 2^a*3^b*5^c RBs
    (36.211 §5.3.3 transform-precoding constraint)."""
    def ok(v):
        for p in (2, 3, 5):
            while v % p == 0:
                v //= p
        return v == 1
    return next(v for v in range(n, 0, -1) if ok(v))


class TddFrameSim:
    """Runs whole TDD radio frames on `device` (None: the card); the
    per-subframe chains are built on first use."""

    def __init__(self, cfg: TddsimConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mask = direction_mask(cfg.tdd_config)
        self.pattern = TDD_PATTERNS[cfg.tdd_config]
        self._dl: dict[int, tuple] = {}
        self._ul: dict[int, tuple] = {}
        self.srs = SrsConfig(srs_bw_rb=4, n_rb=cfg.n_rb) \
            if cfg.n_rb >= 6 else None
        # DwPTS symbol budget for the special subframe
        ssf = special_symbols(cfg.ssf_config)
        self.dwpts, self.uppts = ssf["dwpts"], ssf["uppts"]

    # ------------------------------------------------------- lazy chains --
    def _dl_pair(self, sf: int):
        if sf not in self._dl:
            cfg = self.cfg
            cell = CellConfig(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell,
                              n_pdcch=cfg.n_pdcch, rnti=cfg.rnti,
                              rb_start=0, n_prb=cfg.n_rb, mcs=cfg.mcs_dl,
                              subframe=sf, tdd=True)
            self._dl[sf] = (EnbTx(cell, self.device),
                            UeRx(cell, n_turbo_iter=cfg.n_turbo_iter,
                                 device=self.device,
                                 decoder_window=cfg.decoder_window))
        return self._dl[sf]

    def _ul_pair(self, sf: int):
        if sf not in self._ul:
            cfg = self.cfg
            ue = UeTx(UeUlConfig(n_rb=cfg.n_rb, mcs=cfg.mcs_ul,
                                 n_rb_alloc=valid_pusch_rb(
                                     max(cfg.n_rb - 2, 1)),
                                 rb_offset=1, rnti=cfg.rnti,
                                 n_id_cell=cfg.n_id_cell, subframe=sf,
                                 n_turbo_iter=cfg.n_turbo_iter,
                                 decoder_window=cfg.decoder_window),
                      self.device)
            self._ul[sf] = (ue, EnbRx(ue))
        return self._ul[sf]

    # ----------------------------------------------------- special (S) sf --
    def _special_dl_waveform(self, enb: EnbTx, B: int):
        """DwPTS: the DL grid truncated to the first `dwpts` symbols (the
        control region + pilots inside DwPTS); GP and UpPTS carry nothing
        downlink."""
        grid = enb.data_subframe(torch.zeros(
            B, enb.am.n_data_re, dtype=torch.complex64, device=self.device))
        grid[:, self.dwpts:] = 0
        return ofdm.ofdm_modulate(grid, enb.fp)

    def _special_ul_waveform(self, fp, B: int):
        """UpPTS: SRS on the last symbol(s) (36.211 §5.5.3.3)."""
        dev = self.device
        grid = torch.zeros(B, fp.symbols_per_subframe, fp.n_fft,
                           dtype=torch.complex64, device=dev)
        if self.srs is not None:
            bins = device_plan(srs_bins(self.srs), dev, dtype=torch.long)
            seq = device_plan(srs_sequence(self.srs), dev)
            for k in range(self.uppts):
                grid[:, fp.symbols_per_subframe - 1 - k, bins] = seq
        return ofdm.ofdm_modulate(grid, fp)

    def draw(self, generator: torch.Generator):
        """One frame's noise normals [10, B, samples, 2] on the device."""
        fp = self._ul_pair(2)[0].fp
        return torch.randn(10, self.cfg.batch, fp.samples_per_tti, 2,
                           generator=generator, device=self.device)

    # -------------------------------------------------------------- frame --
    def run_frame(self, snr_db: float, seed: int = 0, noise=None) -> dict:
        """One radio frame across all 10 subframes. noise[sf] [B, samples,
        2] are subframe sf's noise normals (None: drawn on the device from
        a generator seeded with `seed`). Returns per-direction block stats
        + the per-subframe activity log (for gating checks) and the DAI
        outcomes."""
        cfg, dev = self.cfg, self.device
        B = cfg.batch
        n0 = float(10.0 ** (-snr_db / 10.0))
        rng = np.random.default_rng(seed)
        if noise is None:
            noise = self.draw(torch.Generator(device=dev).manual_seed(seed))
        log = []
        dl_ok = dl_tot = ul_ok = ul_tot = 0
        srs_snr = None
        # TDD DAI HARQ bookkeeping (36.213 §7.3): the eNB counts DL
        # assignments V_DAI into each TDD DCI; the UE cross-checks its
        # decode count against the received DAI to DETECT missed
        # assignments before bundling its ACKs (the reference's
        # *_TDD_* DCI structs + phy_procedures ACK/NAK bundling).
        v_dai = 0                           # eNB-side assignment counter
        dec_count = np.zeros(B, np.int64)   # UE decodes so far
        dai_miss = np.zeros(B, bool)        # UE detected a missed DCI
        ack_bundle = np.ones(B, bool)       # AND of per-assignment ACKs

        for sf in range(10):
            d = self.pattern[sf]
            if d == "D":
                enb, ue = self._dl_pair(sf)
                # eNB: this assignment's DAI rides the TDD format-1A DCI
                v_dai += 1
                enb.set_dci_payload(pack_dci_format1a(
                    cfg.n_rb, rb_start=0, n_prb=cfg.n_rb, mcs=cfg.mcs_dl,
                    harq_pid=sf & 7, ndi=1, rv=0, tdd=True,
                    dai=(v_dai - 1) & 3))
                tb = torch.as_tensor(
                    rng.integers(0, 2, (B, ue.codec.cfg.tbs)),
                    dtype=torch.int32, device=dev)
                e = scramble_bits(ue.codec.encode(tb), ue.scr_seq)
                t = enb.data_waveform(map_symbols(e, ue.codec.cfg.Qm))
                rx = t + _noise(noise[sf], n0, dev)
                out = ue.receive(ofdm.ofdm_demodulate(rx, enb.fp), n0,
                                 ue.make_wiener(n0))
                found = out["dci_found"].cpu().numpy()
                payload = out["dci_payload"].cpu().numpy()
                ok = out["tb_ok"].cpu().numpy() & found
                # UE DAI check: decoded DAI must equal its own count mod 4
                for i in np.nonzero(found)[0]:
                    dai_rx = unpack_dci_format1a(
                        payload[i], cfg.n_rb, tdd=True)["dai"]
                    if dai_rx != (dec_count[i] & 3):
                        dai_miss[i] = True      # a DCI was missed earlier
                    dec_count[i] += 1
                ack_bundle &= ok
                dl_ok += int(ok.sum())
                dl_tot += B
                log.append((sf, "D", "enb_tx+ue_rx"))
            elif d == "U":
                ue, enb = self._ul_pair(sf)
                tb = torch.as_tensor(
                    rng.integers(0, 2, (B, ue.codec.cfg.tbs)),
                    dtype=torch.int32, device=dev)
                rx = ue.pusch_subframe(tb) + _noise(noise[sf], n0, dev)
                _, ok, _ = enb.receive_pusch(rx, n0)
                ul_ok += int(ok.sum())
                ul_tot += B
                log.append((sf, "U", "ue_tx+enb_rx"))
            else:                       # special subframe
                enb, _ = self._dl_pair(0 if self.mask[0] == 0 else sf)
                t_dl = self._special_dl_waveform(enb, B)
                # GP must be silent: the tail symbols carry no energy
                grid_chk = ofdm.ofdm_demodulate(t_dl, enb.fp)
                gp_energy = float(torch.mean(grid_chk[
                    :, self.dwpts:-self.uppts or None].abs() ** 2))
                if not gp_energy < 1e-9:
                    raise AssertionError(f"DL energy {gp_energy} in the GP")
                ue_ul, _ = self._ul_pair(2)     # any UL config for fp
                t_ul = self._special_ul_waveform(ue_ul.fp, B)
                rx = t_ul + _noise(noise[sf], n0, dev)
                if self.srs is not None:
                    rgrid = ofdm.ofdm_demodulate(rx, ue_ul.fp)
                    _, snr_wb, _ = srs_estimate(
                        rgrid[:, ue_ul.fp.symbols_per_subframe - 1],
                        self.srs)
                    srs_snr = float(snr_wb.mean())
                log.append((sf, "S", f"dwpts{self.dwpts}+uppts{self.uppts}"))
        # a trial that decoded fewer assignments than the eNB sent has
        # missed at least the LAST one too (no later DAI to expose it):
        # bundled ACK is withheld (DTX) exactly as 36.213 §7.3 intends
        dai_miss |= dec_count < v_dai
        return dict(dl_ok=dl_ok, dl_tot=dl_tot, ul_ok=ul_ok, ul_tot=ul_tot,
                    srs=srs_snr, log=log,
                    dl_bler=1 - dl_ok / max(dl_tot, 1),
                    ul_bler=1 - ul_ok / max(ul_tot, 1),
                    n_dl_assignments=v_dai,
                    dai_miss=dai_miss.copy(),
                    ack_bundle=(ack_bundle & ~dai_miss).copy())
