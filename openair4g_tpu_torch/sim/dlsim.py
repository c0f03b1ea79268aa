"""Fading-channel downlink link simulator, first HARQ round (counterpart of
openair4g_tpu/sim/dlsim.py `DlsimFading`).

One round runs [batch] complete subframes: DLSCH encode, scrambling, QAM
mapping, grid fill with pilots, PCFICH and the UE's format-1A DCI, the
fading channel (frequency domain) and AWGN, OFDM, joint 2D-LMMSE channel
estimation, the fused MRC/LLR pass, the DCI blind decode, and the turbo
decode. SNR is per data RE: with unitary FFTs and unit-energy symbols the
time-domain noise variance n0 = 10^(-SNR/10) gives Es/N0 = SNR per RE.

The slice ported here is round 0 with est_mode="joint", one RX antenna
and the frequency-domain channel; any other configuration raises
NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import FrameParms
from ..device import default_device
from ..ops.equalize_llr import mrc_llr
from ..ops.gold import (gold_sequence, pdsch_cinit, scramble_bits,
                        unscramble_llrs)
from ..ops.llr import map_symbols
from ..phy import ofdm
from ..phy.control_region import make_control_region_map
from ..phy.channel_est import (estimate_channel_joint, joint_err_var,
                               make_wiener_joint, measure_delay_prior)
from ..phy.pdcch import (BITS_PER_CCE, cfi_encode, common_search_candidates,
                         dci_blind_decode, dci_encode, pack_dci_format1a,
                         pdcch_scramble_seq, ue_search_candidates)
from ..phy.pdsch import DlschCodec, DlschConfig
from ..phy.resource_grid import extract_data_res, fill_grid, make_grid_map
from .channels import ChannelModel, apply_channel_grid


@dataclass(frozen=True)
class DlsimFadingConfig:
    """Same fields and defaults as the reference's DlsimFadingConfig."""
    mcs: int = 5
    n_rb: int = 50
    channel: str = "EVA"
    n_harq_rounds: int = 4
    perfect_ce: bool = False
    n_rx: int = 1
    harq_doppler_hz: float = 0.0
    delay_scale: float = 1.0
    est_mode: str = "interp"
    snr_convention: str = "per_re"
    est_prior: str = "adaptive"   # "adaptive" (measured) or "exp"
    use_est_err_var: bool = True
    n_pdcch_symbols: int = 1
    subframe: int = 7
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64
    time_domain_channel: bool = False
    intra_doppler_hz: float = 0.0
    with_pdcch: bool = True


class RoundResult(NamedTuple):
    ok: torch.Tensor        # [B] TB decoded and its DCI found
    dci_ok: torch.Tensor    # [B] DCI blind-decoded with the sent payload
    bit_errs: torch.Tensor  # [B] decoded TB bits that differ from the sent
    w_soft: list            # per-block order-space soft buffers [B, L]


def _check_slice(cfg: DlsimFadingConfig) -> None:
    unsupported = {
        "n_harq_rounds > 1": cfg.n_harq_rounds > 1,
        "est_mode != 'joint'": cfg.est_mode != "joint",
        "n_rx > 1": cfg.n_rx > 1,
        "time_domain_channel": cfg.time_domain_channel,
        "intra_doppler_hz > 0": cfg.intra_doppler_hz > 0,
        "perfect_ce": cfg.perfect_ce,
        "est_prior not in ('adaptive', 'exp')":
            cfg.est_prior not in ("adaptive", "exp"),
        "harq_doppler_hz > 0": cfg.harq_doppler_hz > 0,
        "snr_convention != 'per_re'": cfg.snr_convention != "per_re",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"DlsimFading port covers round 0 of the joint-estimation SISO "
            f"chain only; unsupported: {', '.join(bad)}")


class DlsimFading:
    """Fading-channel downlink simulator, round 0, joint channel estimation.

    `round0` takes injected draws (TB bits, tap normals, noise normals);
    `step` draws them on the card from a torch.Generator."""

    def __init__(self, cfg: DlsimFadingConfig, device=None):
        _check_slice(cfg)
        self.cfg = cfg
        self.device = default_device() if device is None \
            else torch.device(device)
        self.dlsch = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb,
            n_pdcch_symbols=cfg.n_pdcch_symbols,
            n_turbo_iter=cfg.n_turbo_iter))
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                cfg.n_id_cell, cfg.subframe)
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp, n_rx=1,
                                 delay_scale=cfg.delay_scale)
        G = self.dlsch.cfg.G
        if self.gm.n_data_re * self.dlsch.cfg.Qm != G:
            raise ValueError(f"grid holds {self.gm.n_data_re} data REs, "
                             f"G = {G}")
        cinit = pdsch_cinit(cfg.rnti, 0, 2 * cfg.subframe, cfg.n_id_cell)
        self.scr_seq = gold_sequence(cinit, G)
        self._adaptive_prior = None
        self.pdcch_on = cfg.with_pdcch
        if cfg.with_pdcch:
            self._init_pdcch()

    def _init_pdcch(self):
        """PCFICH + the UE's format-1A DCI at the largest aggregation its
        search spaces allow, blind-decoded per trial at the UE."""
        cfg = self.cfg
        ns = 2 * cfg.subframe
        self.crm = make_control_region_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                           cfg.n_id_cell)
        n_cce = self.crm.n_cce
        common = common_search_candidates(n_cce)
        uespec = ue_search_candidates(n_cce, cfg.rnti, cfg.subframe)
        self.dci_cands = common + [c for c in uespec if c not in common]
        if not self.dci_cands:
            self.pdcch_on = False
            return
        cand = max(self.dci_cands, key=lambda c: c.L)
        self.dci_payload = pack_dci_format1a(
            cfg.n_rb, rb_start=0, n_prb=cfg.n_rb, mcs=cfg.mcs,
            harq_pid=0, ndi=1, rv=0)
        e = dci_encode(self.dci_payload, cfg.rnti, cand.L)
        self.pdcch_scr = pdcch_scramble_seq(cfg.n_id_cell, ns,
                                            n_cce * BITS_PER_CCE)
        full = np.zeros(n_cce * BITS_PER_CCE, np.int8)
        off = cand.cce_offset * BITS_PER_CCE
        full[off:off + len(e)] = e ^ self.pdcch_scr[off:off + len(e)]
        used = np.zeros(len(full) // 2, bool)
        used[off // 2:(off + len(e)) // 2] = True
        syms = ((1 - 2 * full[0::2]) + 1j * (1 - 2 * full[1::2])) \
            / np.sqrt(2)
        self.pdcch_syms = np.where(used, syms, 0).astype(np.complex64)
        cinit = ((ns // 2 + 1) * (2 * cfg.n_id_cell + 1) << 9) \
            + cfg.n_id_cell
        b = cfi_encode(cfg.n_pdcch_symbols) \
            ^ gold_sequence(cinit, 32).astype(np.int8)
        self.pcfich_syms = (((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2]))
                            / np.sqrt(2)).astype(np.complex64)

    # ------------------------------------------------- estimator state --
    def _prior(self):
        return self._adaptive_prior if self.cfg.est_prior == "adaptive" \
            else None

    def _measure_prior(self, snr_db: float, n_probe: int = 64,
                       seed: int = 9090) -> np.ndarray:
        """One probe batch of pilots through a fresh channel draw and AWGN
        on the port's own channel and OFDM path, then measure_delay_prior
        on the received grid (no channel-model knowledge)."""
        n0 = 10.0 ** (-snr_db / 10.0)
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        sym = torch.zeros(n_probe, len(self.gm.data_sc), dtype=torch.complex64,
                          device=dev)
        grid = fill_grid(sym, self.gm)                  # pilots only
        taps = self.chan.draw_taps(n_probe, generator=gen, device=dev)
        grid = apply_channel_grid(grid, self.chan.freq_response(taps),
                                  self.fp)
        t = ofdm.ofdm_modulate(grid, self.fp)
        nr = torch.randn(n_probe, t.shape[1], 2, generator=gen, device=dev)
        rx = t + float(np.sqrt(n0 / 2)) * torch.complex(nr[..., 0],
                                                        nr[..., 1])
        rgrid = ofdm.ofdm_demodulate(rx, self.fp)
        return measure_delay_prior(rgrid.cpu().numpy(), self.gm, n0)

    def _ensure_prior(self, snr_db: float) -> None:
        if self.cfg.est_prior == "adaptive" and self._adaptive_prior is None:
            self._adaptive_prior = self._measure_prior(snr_db)

    def wiener(self, snr_db: float):
        """Joint estimator matrix, complex64 [Np_total, n_sc] on the device."""
        self._ensure_prior(snr_db)
        w = make_wiener_joint(self.gm, 10.0 ** (-snr_db / 10.0),
                              prior=self._prior())
        return torch.complex(torch.from_numpy(w[..., 0]),
                             torch.from_numpy(w[..., 1])).to(self.device)

    def err_var(self, snr_db: float):
        """[n_data] float32 per-RE estimation-error variance on the device
        (zeros when use_est_err_var is off)."""
        if not self.cfg.use_est_err_var:
            return torch.zeros(len(self.gm.data_sc), device=self.device)
        self._ensure_prior(snr_db)
        ev = joint_err_var(self.gm, 10.0 ** (-snr_db / 10.0),
                           prior=self._prior())
        return torch.as_tensor(ev[self.gm.data_sc], device=self.device)

    # ------------------------------------------------------------ round --
    def round0(self, tb_bits, tap_normals, noise_normals, n0, W, ev):
        """Round 0 on injected draws.

        tb_bits [B, TBS] {0,1}; tap_normals [B, 1, 1, T, 2] and
        noise_normals [B, 1, samples_per_tti, 2] standard normals; n0 the
        noise variance; W, ev from wiener/err_var (or convert.py)."""
        cfg, codec, gm, fp = self.cfg, self.dlsch, self.gm, self.fp
        dev = self.device
        B = tb_bits.shape[0]
        Qm = codec.cfg.Qm
        n0 = float(np.float32(n0))
        tb_bits = tb_bits.to(dev)
        e = codec.select_e(codec.encode_to_d(tb_bits), 0)
        e = scramble_bits(e, self.scr_seq)
        grid = fill_grid(map_symbols(e, Qm), gm)
        if self.pdcch_on:
            crm = self.crm
            p_sym = torch.as_tensor(crm.pdcch_sym, dtype=torch.long,
                                    device=dev)
            p_bin = torch.as_tensor(crm.pdcch_bin, dtype=torch.long,
                                    device=dev)
            grid[:, p_sym, p_bin] = torch.as_tensor(self.pdcch_syms,
                                                    device=dev)
            grid[:, torch.as_tensor(crm.pcfich_sym, dtype=torch.long,
                                    device=dev),
                 torch.as_tensor(crm.pcfich_bin, dtype=torch.long,
                                 device=dev)] = \
                torch.as_tensor(self.pcfich_syms, device=dev)
        taps = self.chan.draw_taps(B, normals=tap_normals.to(dev))
        grid = apply_channel_grid(grid, self.chan.freq_response(taps), fp)
        t = ofdm.ofdm_modulate(grid, fp)
        nn = noise_normals.to(dev, torch.float32)
        noise = torch.complex(nn[..., 0], nn[..., 1]).reshape(B, -1)
        sigma = float(np.sqrt(np.float32(n0) / np.float32(2.0)))
        rx = t + sigma * noise
        rgrid = ofdm.ofdm_demodulate(rx, fp)
        H_hat = estimate_channel_joint(rgrid, gm, W)
        data_sym = torch.as_tensor(gm.data_sym, dtype=torch.long, device=dev)
        data_sc = torch.as_tensor(gm.data_sc, dtype=torch.long, device=dev)
        H_data = H_hat[:, data_sym, data_sc]
        y = extract_data_res(rgrid, gm)
        # one RX antenna: [B, n_data, A=1]; noise n0 + ev per data RE
        llr = mrc_llr(y[..., None].contiguous(), H_data[..., None].contiguous(),
                      n0 + ev, Qm).reshape(B, -1)
        llr = unscramble_llrs(llr, self.scr_seq)
        if self.pdcch_on:
            p_sc = torch.as_tensor(self.crm.pdcch_sc, dtype=torch.long,
                                   device=dev)
            y_c = rgrid[:, p_sym, p_bin]
            H_c = H_hat[:, p_sym, p_sc]
            llr_c = mrc_llr(y_c[..., None].contiguous(),
                            H_c[..., None].contiguous(), n0, 2).reshape(B, -1)
            pd_sgn = torch.as_tensor(
                1.0 - 2.0 * self.pdcch_scr.astype(np.float32), device=dev)
            found, dbits, _ = dci_blind_decode(
                llr_c * pd_sgn, len(self.dci_payload), cfg.rnti,
                self.dci_cands)
            expected = torch.as_tensor(self.dci_payload, device=dev)
            dci_ok = found & torch.all(dbits == expected, dim=-1)
            llr = llr * dci_ok[:, None]
        else:
            dci_ok = torch.ones(B, dtype=torch.bool, device=dev)
        tb_hat, ok, w_soft = codec.decode(llr, rv=0)
        bit_errs = (tb_hat != tb_bits).sum(dim=1)
        return RoundResult(ok & dci_ok, dci_ok, bit_errs, w_soft)

    def step(self, generator: torch.Generator, n0, W, ev) -> RoundResult:
        """Round 0 on [batch] trials drawn on the card from `generator`."""
        if not torch.cuda.is_available() or self.device.type != "cuda":
            raise RuntimeError("DlsimFading.step runs on a CUDA device; "
                               f"this simulator is on {self.device}")
        B = self.cfg.batch
        dev = self.device
        tb = torch.randint(0, 2, (B, self.dlsch.cfg.tbs), generator=generator,
                           device=dev, dtype=torch.int32)
        taps = torch.randn(B, 1, 1, self.chan.n_taps, 2, generator=generator,
                           device=dev)
        noise = torch.randn(B, 1, self.fp.samples_per_tti, 2,
                            generator=generator, device=dev)
        return self.round0(tb, taps, noise, n0, W, ev)
