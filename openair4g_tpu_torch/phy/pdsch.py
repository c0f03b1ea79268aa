"""DLSCH transport-channel processing, the 36.212 §5.3.2 bit chain
(counterpart of openair4g_tpu/phy/pdsch.py): CRC24A, segmentation, turbo
encode, rate matching; and back through rate de-matching with the HARQ
soft buffer, turbo decode with the CRC latch, and the TB CRC24A check.
On the card each half is a few launches of hand-written kernels
(ops/dlsch_cuda); on the CPU the plain torch ops (the *_ref methods).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import dlsch_cuda, turbo
from ..ops.crc import crc_device, crc_matrix, crc_remainder
from ..ops.rate_match import (block_e_sizes, block_layout, rate_match_rx,
                              rate_match_tx, w_to_d_llr)
from ..ops.segmentation import Segmentation, segment_tb
from ..tables.tbs import get_G_dl, get_Qm, get_TBS_DL
from ..utils.tracing import annotate


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
        C = segment_tb(cfg.tbs + 24).C
        self.Es = block_e_sizes(cfg.G, C, cfg.Qm)
        self.layout = block_layout(cfg.tbs, tuple(self.Es))
        self.seg: Segmentation = self.layout.seg
        self.block_Ks = list(self.layout.Ks)
        self.maps_by_rv = self.layout.maps_by_rv
        self.maps = self.maps_by_rv[cfg.rv]
        self.block_payload = self.layout.payload
        self.groups = self.layout.groups

    # ------------------------------------------------------------------ TX --
    def encode_to_d(self, tb_bits):
        """tb_bits [B, TBS] -> list of per-block d_flat [B, 3*(K+4)]. A CUDA
        tensor takes two kernel launches (ops/dlsch_cuda.encode), the blocks'
        streams views of one buffer; a CPU tensor encode_to_d_ref."""
        if tb_bits.device.type == "cpu":
            return self.encode_to_d_ref(tb_bits)
        p = self.kernel_plan()
        return dlsch_cuda.views(dlsch_cuda.encode(tb_bits, p), p)

    def encode_to_d_ref(self, tb_bits):
        """The plain version of encode_to_d, on any device: CRC24A,
        segmentation and each block's CRC24B as GF(2) products, the turbo
        encoder's cumsum scans (ops/turbo.turbo_encode_device)."""
        seg = self.seg
        B = tb_bits.shape[0]
        with annotate("oai4g:encode.crc_seg"):
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
        with annotate("oai4g:encode.turbo"):
            return [d.reshape(B, -1) for d in self._encode_blocks(blocks)]

    def select_e(self, d_flats, rv: int | None = None):
        """Rate-match the encoded streams for one redundancy version: one
        kernel launch for CUDA streams, which must be encode_to_d's views
        (ops/dlsch_cuda.select), select_e_ref for CPU ones."""
        rv = self.cfg.rv if rv is None else rv
        with annotate("oai4g:encode.rate_match"):
            if d_flats[0].device.type == "cpu":
                return self.select_e_ref(d_flats, rv)
            return dlsch_cuda.select(d_flats, self.kernel_plan(), rv)

    def select_e_ref(self, d_flats, rv: int):
        """The plain version of select_e, on any device: a gather a block."""
        maps = self.maps_by_rv[rv]
        return torch.cat([rate_match_tx(d, maps[r])
                          for r, d in enumerate(d_flats)], dim=1)

    def kernel_plan(self) -> dlsch_cuda.EncodePlan:
        """The plan the card's encode and select kernels read."""
        return dlsch_cuda.plan(self.cfg.tbs, tuple(self.Es))

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
               dynamic_stop: bool = True, iters: list | None = None):
        """e_llr [B, G] -> (tb_bits [B, TBS], tb_ok [B], w_soft list).

        `w_soft`: per-block soft buffers of an earlier HARQ round, or None;
        the returned list feeds the next round (never written here). `rv`
        must match the transmitter's redundancy version. `dynamic_stop=
        False` runs all n_turbo_iter iterations (the outputs are the same
        either way). `iters`: a list, or None; for a list, each (K, F)
        group's decode appends ((K, F), the iterations its rows ran), an
        int32 tensor on the device, read by the caller whenever it syncs.
        A CUDA tensor takes a launch of the de-rate-matching kernel, one
        of the decode kernel a (K, F) group and one of the TB check
        (ops/dlsch_cuda.dematch and tb_check; the blocks' soft buffers
        views of one buffer); a CPU tensor decode_ref."""
        if e_llr.device.type == "cpu":
            return self.decode_ref(e_llr, w_soft, rv, dynamic_stop, iters)
        rv = self.cfg.rv if rv is None else rv
        p = self.decode_plan()
        B = e_llr.shape[0]
        with annotate("oai4g:decode.dematch"):
            w, d = dlsch_cuda.dematch(e_llr, w_soft, p, rv)
        with annotate("oai4g:decode.turbo"):
            decoded = self._turbo(dlsch_cuda.group_inputs(d, p, B),
                                  dynamic_stop, iters)
        with annotate("oai4g:decode.crc"):
            b_hat, tb_ok = dlsch_cuda.tb_check(decoded, p)
        return b_hat[:, :self.cfg.tbs], tb_ok, dlsch_cuda.w_views(w, p)

    def decode_ref(self, e_llr, w_soft=None, rv: int | None = None,
                   dynamic_stop: bool = True, iters: list | None = None):
        """The plain version of decode, on any device: dematch_ref, each
        group's blocks concatenated into turbo_decode, tb_check_ref."""
        with annotate("oai4g:decode.dematch"):
            new_w, d_llrs = self.dematch_ref(e_llr, w_soft, rv)
        with annotate("oai4g:decode.turbo"):
            decoded = self._turbo([torch.cat([d_llrs[r] for r in rs], dim=0)
                                   for _, _, rs in self.groups],
                                  dynamic_stop, iters)
        with annotate("oai4g:decode.crc"):
            b_hat, tb_ok = self.tb_check_ref(decoded)
        return b_hat[:, :self.cfg.tbs], tb_ok, new_w

    def dematch_ref(self, e_llr, w_soft=None, rv: int | None = None):
        """Each block's new soft buffer (rate_match_rx with the HARQ add)
        and decoder input [B, 3, K + 4] (w_to_d_llr): two lists."""
        maps = self.maps_by_rv[self.cfg.rv if rv is None else rv]
        pos = 0
        new_w, d_llrs = [], []
        for r in range(self.seg.C):
            E = self.Es[r]
            w = rate_match_rx(e_llr[:, pos:pos + E], maps[r],
                              None if w_soft is None else w_soft[r])
            pos += E
            new_w.append(w)
            d_llrs.append(w_to_d_llr(w, maps[r]))
        return new_w, d_llrs

    def tb_check_ref(self, decoded):
        """(b_hat [B, TBS + 24], tb_ok [B]) from each group's (bits, done)
        in self.groups' order: the blocks' payloads in turn, their flags
        and the TB's CRC24A as a GF(2) product."""
        seg = self.seg
        L = 24 if seg.C > 1 else 0
        payloads = [None] * seg.C
        all_ok = None
        for (_, F, rs), (bits, ok) in zip(self.groups, decoded):
            B = bits.shape[0] // len(rs)
            for i, r in enumerate(rs):
                payloads[r] = bits[i * B:(i + 1) * B, F:bits.shape[1] - L]
                flag = ok[i * B:(i + 1) * B]
                all_ok = flag if all_ok is None else all_ok & flag
        b_hat = torch.cat(payloads, dim=1)                     # [B, TBS+24]
        rem = crc_remainder(b_hat, crc_matrix(self.cfg.tbs + 24, "crc24a"))
        return b_hat, all_ok & torch.all(rem < 0.5, dim=-1)

    def decode_plan(self) -> dlsch_cuda.DecodePlan:
        """The plan the card's de-rate-matching and TB check kernels read."""
        return dlsch_cuda.decode_plan(self.cfg.tbs, tuple(self.Es))

    def _turbo(self, inputs, dynamic_stop: bool, iters):
        """turbo_decode of each (K, F) group's input [n B, 3, K + 4], in
        self.groups' order: [(bits, done)]."""
        cfg, seg = self.cfg, self.seg
        win = cfg.decoder_window
        if win is None:
            win = 96 if inputs[0].device.type == "cpu" else 240
        out = []
        for (K, F, _), stacked in zip(self.groups, inputs):
            dcfg = turbo.TurboDecoderConfig(
                K=K, F=F, n_iter=cfg.n_turbo_iter, window=win,
                warmup=cfg.decoder_warmup,
                crc_kind="crc24b" if seg.C > 1 else "crc24a",
                dynamic_stop=dynamic_stop)
            ran = None
            if iters is not None:
                ran = torch.empty(stacked.shape[0], dtype=torch.int32,
                                  device=stacked.device)
                iters.append(((K, F), ran))
            out.append(turbo.turbo_decode(stacked, dcfg, ran))
        return out
