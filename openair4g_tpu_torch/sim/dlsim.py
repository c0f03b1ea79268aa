"""Downlink link simulators (counterpart of openair4g_tpu/sim/dlsim.py):
`DlsimAwgn`, AWGN with perfect channel knowledge, and `DlsimFading`, the
fading-channel simulator with HARQ, channel estimation and 1 or 2 RX
antennas.

One `DlsimFading` trial runs [batch] subframes through every HARQ round:
DLSCH encode (once), then per round rv = round & 3 rate matching,
scrambling, QAM mapping, grid fill with pilots, PCFICH and the UE's
format-1A DCI, the round's channel (a fresh fade, an AR(1) evolution at
the HARQ RTT, per-OFDM-symbol Jakes trajectories, or the time-domain FIR),
AWGN, OFDM demodulation, channel estimation (interp, joint or
decision-directed, or the genie channel), the fused MRC/LLR pass, the DCI
blind decode, and the turbo decode of the soft-combined buffers. SNR is
per data RE: with unitary FFTs and unit-energy symbols the time-domain
noise variance n0 = 10^(-SNR/10) gives Es/N0 = SNR per RE;
snr_convention="dlsim" applies the reference dlsim's grid-average offset.

`trial` takes every draw injected (TB bits; per round the channel normals
and the noise normals), so it replays another generator's draws; `step`
draws them on the simulator's device from a torch.Generator.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import FrameParms
from ..convert import from_packed, wiener_stack_from_reference
from ..device import resolve_device
from ..ops.equalize_llr import mrc_llr
from ..ops.gold import gold_sequence, pdsch_cinit
from ..ops.llr import demap_llr, map_symbols
from ..phy import ofdm
from ..phy.control_region import make_control_region_map
from ..phy.channel_est import (dd_refine, estimate_channel,
                               estimate_channel_joint, joint_err_var,
                               make_dd_smoother, make_wiener_joint,
                               make_wiener_stack, measure_delay_prior,
                               pdp_prior, qam_hard_slice)
from ..phy.pdcch import (BITS_PER_CCE, cfi_encode, common_search_candidates,
                         dci_blind_decode, dci_encode, pack_dci_format1a,
                         pdcch_scramble_seq, ue_search_candidates)
from ..phy.pdsch import DlschCodec, DlschConfig
from ..phy.resource_grid import extract_data_res, fill_grid, make_grid_map
from ..utils import profiler
from ..utils.tracing import annotate
from .channels import (PROFILES, ChannelModel, apply_channel_grid,
                       apply_channel_grid_timevar, apply_channel_time,
                       draw_taps_timevar, fir_freq_response,
                       harq_forgetting_factor)


class RoundResult(NamedTuple):
    ok: torch.Tensor        # [B] TB decoded and its DCI found
    dci_ok: torch.Tensor    # [B] DCI blind-decoded with the sent payload
    bit_errs: torch.Tensor  # [B] decoded TB bits that differ from the sent
    w_soft: list            # per-block order-space soft buffers [B, L]


class TrialResult(NamedTuple):
    rounds: list            # one RoundResult per HARQ round
    errs: torch.Tensor      # [R] trials that reached round r and failed it
    reach: torch.Tensor     # [R] trials that reached round r


def _idx(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)


def _noise(noise_normals, n0: float, dev):
    """sqrt(n0 / 2) (n_re + j n_im) from normals [..., 2], in float32."""
    nn = noise_normals.to(dev, torch.float32)
    sigma = float(np.sqrt(np.float32(n0) / np.float32(2.0)))
    return sigma * torch.complex(nn[..., 0], nn[..., 1])


@dataclass(frozen=True)
class DlsimConfig:
    """The reference's DlsimConfig fields and defaults, plus decoder_window
    (None: 96 on the CPU, 240 on a card)."""
    mcs: int = 4
    n_rb: int = 25
    n_pdcch_symbols: int = 1
    subframe: int = 7
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64
    decoder_window: int | None = None


class DlsimAwgn:
    """AWGN downlink simulator with perfect channel knowledge: the plain
    max-log demap (ops/llr.demap_llr) on the received data REs."""

    def __init__(self, cfg: DlsimConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dlsch = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb, n_pdcch_symbols=cfg.n_pdcch_symbols,
            n_turbo_iter=cfg.n_turbo_iter,
            decoder_window=cfg.decoder_window))
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.gm = make_grid_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                cfg.n_id_cell, cfg.subframe)
        G = self.dlsch.cfg.G
        if self.gm.n_data_re * self.dlsch.cfg.Qm != G:
            raise ValueError(f"grid holds {self.gm.n_data_re} data REs, "
                             f"G = {G}")
        scr = gold_sequence(pdsch_cinit(cfg.rnti, 0, 2 * cfg.subframe,
                                        cfg.n_id_cell), G)
        self._scr = torch.as_tensor(scr, dtype=torch.int32,
                                    device=self.device)
        self._scr_sgn = 1.0 - 2.0 * self._scr.to(torch.float32)

    def trial(self, tb_bits, noise_normals, n0) -> RoundResult:
        """[B] subframes on injected draws: tb_bits [B, TBS] {0,1},
        noise_normals [B, samples_per_tti, 2] standard normals, n0 the
        noise variance."""
        codec, gm, fp, dev = self.dlsch, self.gm, self.fp, self.device
        B, Qm = tb_bits.shape[0], codec.cfg.Qm
        n0 = float(np.float32(n0))
        tb_bits = tb_bits.to(dev)
        e = torch.bitwise_xor(codec.encode(tb_bits), self._scr)
        t = ofdm.ofdm_modulate(fill_grid(map_symbols(e, Qm), gm), fp)
        rgrid = ofdm.ofdm_demodulate(t + _noise(noise_normals, n0, dev), fp)
        llr = demap_llr(extract_data_res(rgrid, gm), n0, Qm).reshape(B, -1)
        tb_hat, ok, w_soft = codec.decode(llr * self._scr_sgn)
        dci_ok = torch.ones(B, dtype=torch.bool, device=dev)
        return RoundResult(ok, dci_ok, (tb_hat != tb_bits).sum(dim=1),
                           w_soft)

    def draw(self, generator: torch.Generator):
        """One step's draws for `trial`, on the simulator's device: the TB
        bits, then the noise normals."""
        B, dev = self.cfg.batch, self.device
        tb = torch.randint(0, 2, (B, self.dlsch.cfg.tbs), generator=generator,
                           device=dev, dtype=torch.int32)
        noise = torch.randn(B, self.fp.samples_per_tti, 2,
                            generator=generator, device=dev)
        return tb, noise

    def step(self, generator: torch.Generator, n0) -> RoundResult:
        """[batch] trials drawn on the simulator's device from
        `generator` (a generator of that device)."""
        return self.trial(*self.draw(generator), n0)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Round-0 block errors at one SNR over ceil(n_frames / batch)
        steps. Returns (errors, trials)."""
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        errs = trials = 0
        for _ in range(-(-n_frames // self.cfg.batch)):
            ok = self.step(gen, n0).ok
            errs += int((~ok).sum())
            trials += ok.numel()
        return errs, trials

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True):
        """SNR sweep; rows of (snr, errs, trials, bler)."""
        rows = []
        for s in snrs:
            errs, trials = self.run_snr(float(s), n_frames, seed)
            bler = errs / trials
            rows.append((float(s), errs, trials, bler))
            if verbose:
                print(f"SNR {s:+6.2f} dB: BLER {bler:.4f} ({errs}/{trials})",
                      flush=True)
            if early_exit and errs == 0:
                break
        return rows


def dlsim_snr_offset_db(gm) -> float:
    """Offset (dB) of the reference dlsim's SNR convention: it sets the
    noise from the subframe's average TX energy over every grid RE, and
    the control region is mostly empty (one DCI at L=1, 36 REs, and the
    16 PCFICH REs), so the per-data-RE Es/N0 exceeds the nominal SNR by
    10 log10(N_grid / N_filled)."""
    n_grid = gm.fp.symbols_per_subframe * gm.fp.n_sc
    n_rs = 8 * gm.fp.n_rb                    # 4 pilot syms x 2 RS/RB (port 0)
    n_filled = gm.n_data_re + n_rs + 36 + 16
    return float(10.0 * np.log10(n_grid / n_filled))


@dataclass(frozen=True)
class DlsimFadingConfig:
    """The reference's DlsimFadingConfig fields and defaults, plus
    decoder_window (None: 96 on the CPU, 240 on a card)."""
    mcs: int = 5
    n_rb: int = 50
    channel: str = "EVA"          # PROFILES key; "AWGN" for flat
    n_harq_rounds: int = 4        # rv = round & 3
    perfect_ce: bool = False
    n_rx: int = 1                 # RX antennas, MRC-combined
    harq_doppler_hz: float = 0.0  # >0: AR(1) Jakes fade across HARQ rounds
    delay_scale: float = 1.0
    est_mode: str = "interp"      # "interp", "joint" or "dd"
    snr_convention: str = "per_re"   # or "dlsim"
    est_prior: str = "adaptive"   # "adaptive" (measured), "exp" or "pdp"
    use_est_err_var: bool = True
    n_pdcch_symbols: int = 1
    subframe: int = 7
    rnti: int = 0x1234
    n_id_cell: int = 0
    n_turbo_iter: int = 8
    batch: int = 64
    time_domain_channel: bool = False
    intra_doppler_hz: float = 0.0    # >0: per-OFDM-symbol Jakes fade
    with_pdcch: bool = True
    decoder_window: int | None = None


def _check_config(cfg: DlsimFadingConfig) -> None:
    choices = {"est_mode": ("interp", "joint", "dd"),
               "est_prior": ("adaptive", "exp", "pdp"),
               "snr_convention": ("per_re", "dlsim")}
    for field, allowed in choices.items():
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"{field}={getattr(cfg, field)!r}: one of "
                             f"{allowed}")
    if cfg.intra_doppler_hz > 0:
        if cfg.est_mode == "dd":
            raise ValueError("intra_doppler_hz > 0 with est_mode='dd': the "
                             "decision-directed pass assumes a channel "
                             "constant over the subframe")
        if cfg.n_rx != 1 or cfg.time_domain_channel:
            raise ValueError("intra_doppler_hz > 0 runs one RX antenna on "
                             "the frequency-domain channel")


class DlsimFading:
    """Fading-channel downlink simulator with HARQ and channel estimation.

    Per trial and HARQ round: a fresh channel (the reference dlsim's
    hold_channel=0) or, with harq_doppler_hz, an AR(1) evolution of the
    last round's; rv cycling 0, 1, 2, 3; soft combining in the per-block
    buffers; n_rx = 2 estimates per antenna and combines by MRC."""

    def __init__(self, cfg: DlsimFadingConfig, device=None):
        _check_config(cfg)
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.dlsch = DlschCodec(DlschConfig(
            mcs=cfg.mcs, n_rb=cfg.n_rb, n_pdcch_symbols=cfg.n_pdcch_symbols,
            n_turbo_iter=cfg.n_turbo_iter,
            decoder_window=cfg.decoder_window))
        self.fp = FrameParms(n_rb=cfg.n_rb, n_id_cell=cfg.n_id_cell)
        self.gm = gm = make_grid_map(cfg.n_rb, cfg.n_pdcch_symbols,
                                     cfg.n_id_cell, cfg.subframe)
        self.chan = ChannelModel(name=cfg.channel, fp=self.fp, n_rx=cfg.n_rx,
                                 delay_scale=cfg.delay_scale)
        self.harq_ff = (harq_forgetting_factor(cfg.harq_doppler_hz)
                        if cfg.harq_doppler_hz > 0 else 0.0)
        G = self.dlsch.cfg.G
        if gm.n_data_re * self.dlsch.cfg.Qm != G:
            raise ValueError(f"grid holds {gm.n_data_re} data REs, G = {G}")
        scr = gold_sequence(pdsch_cinit(cfg.rnti, 0, 2 * cfg.subframe,
                                        cfg.n_id_cell), G)
        # static plans, on the device once
        self._scr = torch.as_tensor(scr, dtype=torch.int32, device=dev)
        self._scr_sgn = 1.0 - 2.0 * self._scr.to(torch.float32)
        self._ds, self._dc = _idx(gm.data_sym, dev), _idx(gm.data_sc, dev)
        self._adaptive_prior = None
        self.dci_miss = 0
        self._stage_meas = False   # sweep(profile=True): time the stages
        self.pdcch_on = cfg.with_pdcch
        if cfg.with_pdcch:
            self._init_pdcch()

    def _init_pdcch(self):
        """PCFICH + the UE's format-1A DCI at the largest aggregation its
        search spaces allow, blind-decoded per trial and round at the UE.
        A cell with no CCE (6 PRB at CFI 1) has no PDCCH."""
        cfg, dev = self.cfg, self.device
        ns = 2 * cfg.subframe
        crm = self.crm = make_control_region_map(cfg.n_rb,
                                                 cfg.n_pdcch_symbols,
                                                 cfg.n_id_cell)
        n_cce = crm.n_cce
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
        pdcch_scr = pdcch_scramble_seq(cfg.n_id_cell, ns,
                                       n_cce * BITS_PER_CCE)
        full = np.zeros(n_cce * BITS_PER_CCE, np.int8)
        off = cand.cce_offset * BITS_PER_CCE
        full[off:off + len(e)] = e ^ pdcch_scr[off:off + len(e)]
        used = np.zeros(len(full) // 2, bool)
        used[off // 2:(off + len(e)) // 2] = True
        syms = ((1 - 2 * full[0::2]) + 1j * (1 - 2 * full[1::2])) \
            / np.sqrt(2)
        cinit = ((ns // 2 + 1) * (2 * cfg.n_id_cell + 1) << 9) \
            + cfg.n_id_cell
        b = cfi_encode(cfg.n_pdcch_symbols) \
            ^ gold_sequence(cinit, 32).astype(np.int8)
        pcfich = ((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2])) / np.sqrt(2)
        self._p_sym, self._p_bin = _idx(crm.pdcch_sym, dev), \
            _idx(crm.pdcch_bin, dev)
        self._p_sc = _idx(crm.pdcch_sc, dev)
        self._c_sym, self._c_bin = _idx(crm.pcfich_sym, dev), \
            _idx(crm.pcfich_bin, dev)
        self._pdcch_syms = torch.as_tensor(
            np.where(used, syms, 0).astype(np.complex64), device=dev)
        self._pcfich_syms = torch.as_tensor(pcfich.astype(np.complex64),
                                            device=dev)
        self._pd_sgn = torch.as_tensor(
            1.0 - 2.0 * pdcch_scr.astype(np.float32), device=dev)
        self._dci_expected = torch.as_tensor(self.dci_payload, device=dev)

    # ------------------------------------------------- estimator state --
    def _prior(self):
        if self.cfg.est_prior == "adaptive":
            return self._adaptive_prior
        if self.cfg.est_prior != "pdp":
            return None
        delays_us, amps_db = PROFILES[self.cfg.channel]
        return pdp_prior(self.fp, delays_us,
                         10.0 ** (0.1 * np.asarray(amps_db)),
                         self.cfg.delay_scale)

    def _measure_prior(self, snr_db: float, n_probe: int = 64,
                       seed: int = 9090) -> np.ndarray:
        """One probe batch of pilots through a fresh single-antenna channel
        draw and AWGN on the port's own channel and OFDM path, then
        measure_delay_prior on the received grid (no channel-model
        knowledge)."""
        n0 = 10.0 ** (-snr_db / 10.0)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        probe = ChannelModel(name=self.cfg.channel, fp=self.fp,
                             delay_scale=self.cfg.delay_scale)
        sym = torch.zeros(n_probe, len(self.gm.data_sc), dtype=torch.complex64,
                          device=dev)
        grid = fill_grid(sym, self.gm)                  # pilots only
        taps = probe.draw_taps(n_probe, generator=gen, device=dev)
        grid = apply_channel_grid(grid, probe.freq_response(taps), self.fp)
        t = ofdm.ofdm_modulate(grid, self.fp)
        nr = torch.randn(n_probe, t.shape[1], 2, generator=gen, device=dev)
        rgrid = ofdm.ofdm_demodulate(t + _noise(nr, n0, dev), self.fp)
        return measure_delay_prior(rgrid.cpu().numpy(), self.gm, n0)

    def _ensure_prior(self, snr_db: float) -> None:
        if self.cfg.est_prior == "adaptive" and self._adaptive_prior is None:
            self._adaptive_prior = self._measure_prior(snr_db)

    def wiener(self, snr_db: float):
        """The estimator's matrices on the device, complex64: for "interp"
        the per-pilot-symbol stack [n_ps, Np, n_sc]; for "joint" the joint
        matrix [Np_total, n_sc]; for "dd" the pair (joint matrix, DD
        smoother [n_sc, n_sc])."""
        n0 = 10.0 ** (-snr_db / 10.0)
        if self.cfg.est_mode == "interp":
            return wiener_stack_from_reference(make_wiener_stack(self.gm, n0),
                                               self.device)
        self._ensure_prior(snr_db)
        wj = from_packed(make_wiener_joint(self.gm, n0, prior=self._prior()),
                         self.device)
        if self.cfg.est_mode == "joint":
            return wj
        wd, _ = make_dd_smoother(self.gm, n0, prior=self._prior())
        return wj, from_packed(wd, self.device)

    def err_var(self, snr_db: float):
        """[n_data] float32 per-RE estimation-error variance on the device:
        the joint estimator's or the DD smoother's posterior, zeros for
        perfect_ce, interp, or use_est_err_var off."""
        cfg = self.cfg
        n0 = 10.0 ** (-snr_db / 10.0)
        if cfg.perfect_ce or not cfg.use_est_err_var \
                or cfg.est_mode == "interp":
            return torch.zeros(len(self.gm.data_sc), device=self.device)
        self._ensure_prior(snr_db)
        if cfg.est_mode == "dd":
            _, post = make_dd_smoother(self.gm, n0, prior=self._prior())
        else:
            post = joint_err_var(self.gm, n0, prior=self._prior())
        return torch.as_tensor(post[self.gm.data_sc], device=self.device)

    # ------------------------------------------------------------ round --
    def _channel(self, rnd: int, grid, tap_draw, noise, taps_prev):
        """The round's channel and AWGN. Returns (rgrid [B*A, nsym, n_fft],
        genie channel at every (symbol, subcarrier) [B, A, nsym or 1, n_sc],
        taps carried to the next round)."""
        cfg, fp, chan = self.cfg, self.fp, self.chan
        B, A = grid.shape[0], cfg.n_rx
        if cfg.intra_doppler_hz > 0:
            taps_sym = draw_taps_timevar(chan, B, cfg.intra_doppler_hz,
                                         normals=tap_draw, device=self.device)
            grid, H_sym = apply_channel_grid_timevar(grid, chan, taps_sym, fp)
            rgrid = ofdm.ofdm_demodulate(ofdm.ofdm_modulate(grid, fp) + noise,
                                         fp)
            return rgrid, H_sym[:, None], taps_sym[:, 0]
        if rnd > 0 and self.harq_ff > 0.0:
            taps = chan.evolve_taps(taps_prev, tap_draw, self.harq_ff)
        else:
            taps = chan.draw_taps(B, normals=tap_draw, device=self.device)
        taps_rx = taps if A == 1 else taps[:, :, 0, :]      # [B(, A), T]
        grid_a = grid if A == 1 else grid.repeat_interleave(A, dim=0)
        if cfg.time_domain_channel:
            H = fir_freq_response(chan, taps_rx)
            t = apply_channel_time(ofdm.ofdm_modulate(grid_a, fp), chan,
                                   taps_rx.reshape(B * A, -1))
        else:
            H = chan.freq_response(taps_rx)
            t = ofdm.ofdm_modulate(
                apply_channel_grid(grid_a, H.reshape(B * A, -1), fp), fp)
        rgrid = ofdm.ofdm_demodulate(t + noise, fp)
        return rgrid, H.reshape(B, A, 1, -1), taps

    def _dd_estimate(self, rgrid, y, W, n0: float):
        """Joint estimate, MRC/ZF hard decisions weighted by their
        confidence, then the decision-directed refinement. y [B, A, n_data]
        -> H2 [B, A, n_sc]. Spans: estimate.dd, and inside it dd.joint,
        dd.decide and dd.refine."""
        B, A = y.shape[:2]
        Wj, Wd = W
        with annotate("oai4g:estimate.dd"):
            with annotate("oai4g:dd.joint"):
                H1 = estimate_channel_joint(rgrid, self.gm, Wj)
            with annotate("oai4g:dd.decide"):
                h1 = H1[:, self._ds, self._dc].reshape(B, A, -1)
                num = torch.sum(torch.conj(h1) * y, dim=1)
                den = torch.sum(h1.abs() ** 2, dim=1)
                # ZF: unbiased amplitudes
                x1 = num / torch.clamp(den, min=1e-9)
                s_hat = qam_hard_slice(x1, self.dlsch.cfg.Qm)
                # soft-erase REs far from their decided point
                conf = torch.exp(-0.5 * (x1 - s_hat).abs() ** 2 * den
                                 / max(n0, 1e-9))
            with annotate("oai4g:dd.refine"):
                H2 = dd_refine(y.reshape(B * A, -1),
                               s_hat.repeat_interleave(A, 0), self.gm, Wd,
                               weight=conf.repeat_interleave(A, 0),
                               rgrid=rgrid)
            return H2.reshape(B, A, -1)

    def round(self, rnd: int, tb_bits, d_flats, tap_draw, noise_normals, n0,
              W, ev, w_soft=None, taps_prev=None):
        """HARQ round `rnd` of a trial: tb_bits [B, TBS], d_flats the
        encoder's streams (DlschCodec.encode_to_d), tap_draw this round's
        channel normals (see `trial`), noise_normals [B, A, S, 2], w_soft
        and taps_prev the previous round's. Returns (RoundResult, taps)."""
        cfg, codec, gm = self.cfg, self.dlsch, self.gm
        dev = self.device
        B, A, Qm = tb_bits.shape[0], cfg.n_rx, codec.cfg.Qm
        n0 = float(np.float32(n0))
        with annotate("oai4g:bitchain.encode"):
            e = codec.select_e(d_flats, rnd & 3)
        with annotate("oai4g:tx.map"):
            e = torch.bitwise_xor(e, self._scr)
            grid = fill_grid(map_symbols(e, Qm), gm)
            if self.pdcch_on:
                grid[:, self._p_sym, self._p_bin] = self._pdcch_syms
                grid[:, self._c_sym, self._c_bin] = self._pcfich_syms
        with annotate("oai4g:frontend"):
            with annotate("oai4g:frontend.channel"):
                noise = _noise(noise_normals, n0, dev).reshape(B * A, -1)
                rgrid, H, taps = self._channel(rnd, grid, tap_draw, noise,
                                               taps_prev)
            with annotate("oai4g:frontend.estimate"):
                y = extract_data_res(rgrid, gm).reshape(B, A, -1)
                if cfg.perfect_ce:
                    H_all = H
                elif cfg.est_mode == "dd":
                    H_all = self._dd_estimate(rgrid, y, W, n0)[:, :, None]
                elif cfg.est_mode == "joint":
                    H_all = estimate_channel_joint(
                        rgrid, gm, W)[:, :1].reshape(B, A, 1, -1)
                else:
                    H_all = estimate_channel(rgrid, gm, W).reshape(
                        B, A, self.fp.symbols_per_subframe, -1)

            def at(sym, sc):  # H_all [B, A, nsym or 1, n_sc] at REs: [B, A, N]
                if H_all.shape[2] == 1:
                    return H_all[:, :, 0, sc]
                return H_all[:, :, sym, sc]

            # MRC over the RX antennas; the estimation-error variance adds
            # to the per-RE noise. The [B, A, N] antenna planes go in as
            # views and are read where they lie.
            with annotate("oai4g:frontend.detect"):
                llr = mrc_llr(y.transpose(1, 2),
                              at(self._ds, self._dc).transpose(1, 2),
                              n0 + ev, Qm).reshape(B, -1) * self._scr_sgn
        with annotate("oai4g:control.dci"):
            if self.pdcch_on:
                # a missed DCI voids the round: its LLRs add nothing
                y_c = rgrid[:, self._p_sym, self._p_bin].reshape(B, A, -1)
                llr_c = mrc_llr(y_c.transpose(1, 2),
                                at(self._p_sym, self._p_sc).transpose(1, 2),
                                n0, 2).reshape(B, -1)
                found, bits, _ = dci_blind_decode(
                    llr_c * self._pd_sgn, len(self.dci_payload), cfg.rnti,
                    self.dci_cands)
                dci_ok = found & torch.all(bits == self._dci_expected, dim=-1)
                llr = llr * dci_ok[:, None]
            else:
                dci_ok = torch.ones(B, dtype=torch.bool, device=dev)
        with annotate("oai4g:bitchain.decode"):
            tb_hat, ok, w_soft = codec.decode(llr, w_soft=w_soft, rv=rnd & 3)
        with annotate("oai4g:sim.harq"):
            res = RoundResult(ok & dci_ok, dci_ok,
                              (tb_hat != tb_bits).sum(dim=1), w_soft)
        return res, taps

    def trial(self, tb_bits, tap_normals, noise_normals, n0, W, ev):
        """[B] trials through every HARQ round on injected draws.

        tb_bits [B, TBS] {0,1}; per round r, tap_normals[r] is the channel
        draw (None for AWGN; [B, nsym, T, 2] with intra_doppler_hz; else
        what ChannelModel.draw_normals gives: [B, n_rx, 1, T, 2], with the
        AoA normals [B] beside it for Rice1/Rice8) and noise_normals[r]
        [B, n_rx, samples_per_tti, 2]; n0 the noise variance; W, ev from
        wiener/err_var (or convert.estimator_state_from_reference).
        Under sweep(profile=True) stage times feed utils/profiler under the
        reference's names (dlsim.c:3266+'s time_meas of every stage); each
        stage waits for its result on the device there, and only there."""
        meas = self._stage_meas
        t0 = time.perf_counter()
        with annotate("oai4g:bitchain.encode"):
            tb_bits = tb_bits.to(self.device)
            d_flats = self.dlsch.encode_to_d(tb_bits)
        if meas:
            profiler.stop_meas("dlsim.tx_encode", t0, d_flats)
        rounds, w_soft, taps = [], None, None
        for rnd in range(self.cfg.n_harq_rounds):
            t0 = time.perf_counter()
            res, taps = self.round(rnd, tb_bits, d_flats, tap_normals[rnd],
                                   noise_normals[rnd], n0, W, ev, w_soft,
                                   taps)
            if meas:
                profiler.stop_meas(f"dlsim.round{rnd}(chan+rx+decode)", t0,
                                   res.ok)
            rounds.append(res)
            w_soft = res.w_soft
        # a trial reaches round r while no earlier round decoded it
        with annotate("oai4g:sim.harq"):
            ok_any = torch.cummax(torch.stack([r.ok for r in rounds]).to(
                torch.int32), dim=0).values.bool()
            fail = (~ok_any).sum(dim=1)
            reach = torch.cat([fail.new_full((1,), tb_bits.shape[0]),
                               fail[:-1]])
        return TrialResult(rounds, fail, reach)

    def draw(self, generator: torch.Generator):
        """One trial's draws for `trial`, on the simulator's device."""
        cfg, dev, B = self.cfg, self.device, self.cfg.batch
        tb = torch.randint(0, 2, (B, self.dlsch.cfg.tbs), generator=generator,
                           device=dev, dtype=torch.int32)
        taps, noise = [], []
        for _ in range(cfg.n_harq_rounds):
            if cfg.intra_doppler_hz > 0 and cfg.channel != "AWGN":
                taps.append(torch.randn(B, self.fp.symbols_per_subframe,
                                        self.chan.n_taps, 2,
                                        generator=generator, device=dev))
            elif cfg.intra_doppler_hz > 0:
                taps.append(None)
            else:
                taps.append(self.chan.draw_normals(B, generator, dev))
            noise.append(torch.randn(B, cfg.n_rx, self.fp.samples_per_tti, 2,
                                     generator=generator, device=dev))
        return tb, taps, noise

    def step(self, generator: torch.Generator, n0, W, ev) -> TrialResult:
        """[batch] trials through every round, drawn on the simulator's
        device from `generator` (a generator of that device)."""
        return self.trial(*self.draw(generator), n0, W, ev)

    def run_snr(self, snr_db: float, n_frames: int, seed: int = 0):
        """Per-round (errs [R], trials [R]) over ceil(n_frames / batch)
        steps; round-0 DCI misses land in self.dci_miss."""
        if self.cfg.snr_convention == "dlsim":
            snr_db = snr_db + dlsim_snr_offset_db(self.gm)
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        W, ev = self.wiener(snr_db), self.err_var(snr_db)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        R = self.cfg.n_harq_rounds
        errs = np.zeros(R, np.int64)
        reach = np.zeros(R, np.int64)
        self.dci_miss = 0
        for _ in range(-(-n_frames // self.cfg.batch)):
            res = self.step(gen, n0, W, ev)
            errs += res.errs.cpu().numpy()
            reach += res.reach.cpu().numpy()
            self.dci_miss += int((~res.rounds[0].dci_ok).sum())
        return errs, reach

    def sweep(self, snrs, n_frames: int, seed: int = 0, verbose: bool = True,
              early_exit: bool = True, profile: bool = False,
              trace_dir: str | None = None):
        """SNR sweep; rows of (snr, errs [R], trials [R], bler [R]).
        profile=True prints the per-stage time_meas table at exit
        (dlsim.c:3266+ parity), its stages timed in every trial of the
        sweep; trace_dir records a trace of one representative step (the
        VCD dumper's equivalent artifact)."""
        self._stage_meas = profile
        try:
            if trace_dir is not None:
                from ..utils.tracing import trace
                snr = float(snrs[0])
                n0 = np.float32(10.0 ** (-snr / 10.0))
                W, ev = self.wiener(snr), self.err_var(snr)
                draws = self.draw(torch.Generator(
                    device=self.device).manual_seed(seed))
                self.trial(*draws, n0, W, ev)  # first calls outside the trace
                with trace(trace_dir, self.device):
                    with annotate("dlsim.step"):
                        self.trial(*draws, n0, W, ev)
            rows = []
            for s in snrs:
                errs, reach = self.run_snr(float(s), n_frames, seed)
                bler = errs / np.maximum(reach, 1)
                rows.append((float(s), errs.copy(), reach.copy(), bler.copy()))
                if verbose:
                    txt = " ".join(f"r{r}:{bler[r]:.3f}({errs[r]}/{reach[r]})"
                                   for r in range(len(bler)))
                    print(f"SNR {s:+6.2f} dB: {txt}", flush=True)
                if early_exit and errs[-1] == 0:
                    break
            if profile:
                profiler.print_meas()
            return rows
        finally:
            self._stage_meas = False
