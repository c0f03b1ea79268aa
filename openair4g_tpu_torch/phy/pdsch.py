"""DLSCH transport-channel processing, the 36.212 §5.3.2 bit chain
(counterpart of openair4g_tpu/phy/pdsch.py): CRC24A, segmentation, turbo
encode, rate matching; and back through rate de-matching with the HARQ
soft buffer, turbo decode with the CRC latch, and the TB CRC24A check.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import turbo
from ..ops.crc import crc_device, crc_matrix, crc_remainder
from ..ops.rate_match import (RateMatchMaps, block_e_sizes, compute_ncb,
                              make_rate_match_maps, rate_match_rx,
                              rate_match_tx, w_to_d_llr)
from ..ops.segmentation import Segmentation, segment_tb
from ..tables.tbs import get_G_dl, get_Qm, get_TBS_DL


@dataclass(frozen=True)
class DlschConfig:
    mcs: int
    n_rb: int
    n_pdcch_symbols: int = 1
    rv: int = 0
    n_turbo_iter: int = 8
    decoder_window: int | None = None   # None: 96 on CPU, 240 on CUDA
    decoder_warmup: int = 24
    nports: int = 1          # TX antenna ports (2: 8 data REs/RB on pilot syms)
    g_override: int | None = None   # another RE budget (the MBSFN region)

    @property
    def tbs(self) -> int:
        return get_TBS_DL(self.mcs, self.n_rb)

    @property
    def Qm(self) -> int:
        return get_Qm(self.mcs)

    @property
    def G(self) -> int:
        """Coded bits of a full-band allocation on `nports` antenna ports,
        or g_override where it is set."""
        if self.g_override is not None:
            return self.g_override
        return get_G_dl(self.n_rb, self.Qm, self.n_pdcch_symbols,
                        siso=self.nports == 1)


class DlschCodec:
    """Static-plan encoder/decoder for one DLSCH configuration."""

    def __init__(self, cfg: DlschConfig):
        self.cfg = cfg
        self.seg: Segmentation = segment_tb(cfg.tbs + 24)
        seg = self.seg
        self.block_Ks = list(seg.block_sizes)
        C = seg.C
        self.Es = block_e_sizes(cfg.G, C, cfg.Qm)
        self.maps_by_rv: dict[int, list[RateMatchMaps]] = {
            rv: [make_rate_match_maps(K, seg.F if r == 0 else 0, rv,
                                      self.Es[r], compute_ncb(K, C))
                 for r, K in enumerate(self.block_Ks)]
            for rv in range(4)}
        self.maps = self.maps_by_rv[cfg.rv]
        L = 24 if C > 1 else 0
        self.block_payload = [K - L - (seg.F if r == 0 else 0)
                              for r, K in enumerate(self.block_Ks)]
        if sum(self.block_payload) != cfg.tbs + 24:
            raise ValueError(f"segmentation carries {sum(self.block_payload)}"
                             f" bits for TBS {cfg.tbs} + 24")

    # ------------------------------------------------------------------ TX --
    def encode_to_d(self, tb_bits):
        """tb_bits [B, TBS] -> list of per-block d_flat [B, 3*(K+4)]."""
        seg = self.seg
        B = tb_bits.shape[0]
        tb_bits = tb_bits.to(torch.int32)
        crc_a = crc_device(tb_bits, "crc24a").round().to(torch.int32)
        b = torch.cat([tb_bits, crc_a], dim=1)
        blocks = []
        pos = 0
        for r, K in enumerate(self.block_Ks):
            n = self.block_payload[r]
            data = b[:, pos:pos + n]
            pos += n
            if r == 0 and seg.F:
                data = torch.cat([data.new_zeros(B, seg.F), data], dim=1)
            if seg.C > 1:
                crc_b = crc_device(data, "crc24b").round().to(torch.int32)
                data = torch.cat([data, crc_b], dim=1)
            blocks.append(data)
        return [d.reshape(B, -1) for d in self._encode_blocks(blocks)]

    def select_e(self, d_flats, rv: int | None = None):
        """Rate-match the encoded streams for one redundancy version."""
        maps = self.maps_by_rv[self.cfg.rv if rv is None else rv]
        return torch.cat([rate_match_tx(d, maps[r])
                          for r, d in enumerate(d_flats)], dim=1)

    def encode(self, tb_bits, rv: int | None = None):
        """tb_bits [B, TBS] int {0,1} -> e [B, G] int32."""
        return self.select_e(self.encode_to_d(tb_bits), rv)

    def _encode_blocks(self, blocks):
        by_k = {}
        for r, blk in enumerate(blocks):
            by_k.setdefault(blk.shape[1], []).append(r)
        out = [None] * len(blocks)
        B = blocks[0].shape[0]
        for K, rs in by_k.items():
            stacked = torch.cat([blocks[r] for r in rs], dim=0)
            d = turbo.turbo_encode_device(stacked, turbo.qpp_interleaver(K))
            for i, r in enumerate(rs):
                out[r] = d[i * B:(i + 1) * B]
        return out

    # ------------------------------------------------------------------ RX --
    def decode(self, e_llr, w_soft=None, rv: int | None = None,
               dynamic_stop: bool = True):
        """e_llr [B, G] -> (tb_bits [B, TBS], tb_ok [B], w_soft list).

        `w_soft`: per-block soft buffers of an earlier HARQ round, or None;
        the returned list feeds the next round. `rv` must match the
        transmitter's redundancy version. `dynamic_stop=False` runs all
        n_turbo_iter iterations (the outputs are the same either way)."""
        cfg, seg = self.cfg, self.seg
        maps = self.maps_by_rv[cfg.rv if rv is None else rv]
        B = e_llr.shape[0]
        pos = 0
        new_w = []
        d_llrs = []
        for r in range(seg.C):
            E = self.Es[r]
            w = rate_match_rx(e_llr[:, pos:pos + E], maps[r],
                              None if w_soft is None else w_soft[r])
            pos += E
            new_w.append(w)
            d_llrs.append(w_to_d_llr(w, maps[r]))

        win = cfg.decoder_window
        if win is None:
            win = 96 if e_llr.device.type == "cpu" else 240
        results = [None] * seg.C
        by_plan = {}
        for r, K in enumerate(self.block_Ks):
            by_plan.setdefault((K, seg.F if r == 0 else 0), []).append(r)
        for (K, F), rs in by_plan.items():
            stacked = torch.cat([d_llrs[r] for r in rs], dim=0)
            dcfg = turbo.TurboDecoderConfig(
                K=K, F=F, n_iter=cfg.n_turbo_iter, window=win,
                warmup=cfg.decoder_warmup,
                crc_kind="crc24b" if seg.C > 1 else "crc24a",
                dynamic_stop=dynamic_stop)
            bits, ok = turbo.turbo_decode(stacked, dcfg)
            for i, r in enumerate(rs):
                results[r] = (bits[i * B:(i + 1) * B], ok[i * B:(i + 1) * B])

        payloads = []
        all_ok = torch.ones(B, dtype=torch.bool, device=e_llr.device)
        L = 24 if seg.C > 1 else 0
        for r in range(seg.C):
            bits, ok = results[r]
            F = seg.F if r == 0 else 0
            payloads.append(bits[:, F:bits.shape[1] - L])
            all_ok = all_ok & ok
        b_hat = torch.cat(payloads, dim=1)                 # [B, TBS+24]
        rem = crc_remainder(b_hat, crc_matrix(cfg.tbs + 24, "crc24a"))
        tb_ok = all_ok & torch.all(rem < 0.5, dim=-1)
        return b_hat[:, :cfg.tbs], tb_ok, new_w
