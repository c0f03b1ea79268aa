"""PUCCH ACK/NACK and CQI error-rate Monte-Carlo (counterpart of
openair4g_tpu/sim/pucchsim.py).

    python3 -m openair4g_tpu_torch.sim.pucchsim -f 2b -s -6 -S 2

The simulator works on the REs: PUCCH occupies one edge RB and the OFDM
round trip is exact under the unitary convention, so AWGN on the REs is
the same channel. Format 1a: BPSK ACK/NACK, coherent detection through
the W4/W3 covers. Format 2: a (20, A) CQI payload, ML decoding; 2a/2b add
1 or 2 ACK bits on the second RS symbol of each slot.

`trial` takes the noise normals injected, so it replays another
generator's draws; `step` draws them on the simulator's device.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..device import cli_device, resolve_device
from ..ops.llr import demap_llr
from ..phy.pucch import (pucch1_detect, pucch1_slot_symbols, pucch2_equalize,
                         pucch2_slot_symbols, pucch2x_ack_symbol,
                         pucch2x_detect, pucch2x_slot_symbols, rm20_decode,
                         rm20_encode)


@dataclass(frozen=True)
class PucchsimConfig:
    n_id_cell: int = 0
    subframe: int = 2
    n_cs1: int = 3            # cyclic-shift resource
    n_oc: int = 1             # orthogonal cover resource (format 1)
    batch: int = 256
    fmt: str = "1a"           # "1a", "2", "2a" (CQI + 1 ACK) or "2b" (+ 2)
    cqi_bits: int = 4         # format 2 payload size A


class Pucchsim:
    def __init__(self, cfg: PucchsimConfig, device=None):
        if cfg.fmt not in ("1a", "2", "2a", "2b"):
            raise ValueError(f"fmt={cfg.fmt!r}: one of 1a, 2, 2a, 2b")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        ns = 2 * cfg.subframe
        d_ref, r_ref = [], []
        if cfg.fmt == "1a":
            # both slots for d = +1; d = -1 is a global sign
            for s in (ns, ns + 1):
                d, r = pucch1_slot_symbols(cfg.n_id_cell, s, cfg.n_cs1,
                                           cfg.n_oc, 1.0)
                d_ref.append(d)
                r_ref.append(r)
        else:
            rng = np.random.default_rng(7)
            self.cqi_payload = rng.integers(
                0, 2, size=cfg.cqi_bits).astype(np.int8)
            self.n_ack = {"2": 0, "2a": 1, "2b": 2}[cfg.fmt]
            self.ack_payload = rng.integers(
                0, 2, size=max(self.n_ack, 1)).astype(np.int8)
            b20 = rm20_encode(self.cqi_payload)
            d10 = ((1 - 2 * b20[0::2].astype(np.float64))
                   + 1j * (1 - 2 * b20[1::2].astype(np.float64))) / np.sqrt(2)
            for i, s in enumerate((ns, ns + 1)):
                if self.n_ack:
                    d, r = pucch2x_slot_symbols(
                        cfg.n_id_cell, s, cfg.n_cs1, d10[5 * i:5 * i + 5],
                        pucch2x_ack_symbol(self.ack_payload[:self.n_ack]))
                else:
                    d, r = pucch2_slot_symbols(cfg.n_id_cell, s, cfg.n_cs1,
                                               d10[5 * i:5 * i + 5])
                d_ref.append(d)
                r_ref.append(r)
            self._cqi_true = torch.as_tensor(
                self.cqi_payload.astype(np.int64), device=dev)
            self._ack_true = torch.as_tensor(
                self.ack_payload[:self.n_ack].astype(np.int32), device=dev)
        # [2 slots, n_data, 12] and [2, n_rs, 12]
        self.tx_data = torch.as_tensor(np.stack(d_ref), device=dev)
        self.tx_rs = torch.as_tensor(np.stack(r_ref), device=dev)

    def trial(self, noise_data, noise_rs, n0):
        """[B] transmissions on injected standard normals: noise_data
        [B, 2, n_data, 12, 2] and noise_rs [B, 2, n_rs, 12, 2] (n_data,
        n_rs = 4, 3 for format 1a and 5, 2 for format 2). Returns good [B]
        bool: the ACK bit (1a; ACK and NACK alternate across the batch), or
        the CQI payload and the ACK bits, decoded right."""
        cfg, dev = self.cfg, self.device
        ns = 2 * cfg.subframe
        B = noise_data.shape[0]
        n0 = float(np.float32(n0))
        sigma = float(np.sqrt(np.float32(n0) / np.float32(2.0)))

        def add_noise(x, nn):
            nn = nn.to(dev, torch.float32) * sigma
            return x + torch.complex(nn[..., 0], nn[..., 1])

        if cfg.fmt == "1a":
            d = 1.0 - 2.0 * (torch.arange(B, device=dev) % 2).to(
                torch.float32)
            rx_d = add_noise(d[:, None, None, None] * self.tx_data,
                             noise_data)
            rx_r = add_noise(self.tx_rs, noise_rs)
            z = 0.0
            for sl, s in enumerate((ns, ns + 1)):
                zc, _ = pucch1_detect(rx_d[:, sl], rx_r[:, sl],
                                      cfg.n_id_cell, s, cfg.n_cs1, cfg.n_oc)
                z = z + zc
            return torch.sign(z.real) == d
        rx_d = add_noise(self.tx_data, noise_data)
        rx_r = add_noise(self.tx_rs, noise_rs)
        zs, acks = [], []
        for sl, s in enumerate((ns, ns + 1)):
            if self.n_ack:
                z, h2, ack = pucch2x_detect(rx_d[:, sl], rx_r[:, sl],
                                            cfg.n_id_cell, s, cfg.n_cs1,
                                            self.n_ack)
                acks.append(ack)
            else:
                z, h2 = pucch2_equalize(rx_d[:, sl], rx_r[:, sl],
                                        cfg.n_id_cell, s, cfg.n_cs1)
            zs.append(z / torch.clamp(h2, min=1e-12)[:, None])
        d_hat = torch.cat(zs, dim=-1)                       # [B, 10]
        llr2 = demap_llr(d_hat, n0, 2)                      # [B, 10, 2]
        bits = rm20_decode(llr2.reshape(B, 20), cfg.cqi_bits)
        cqi_ok = torch.all(bits == self._cqi_true, dim=-1)
        if not self.n_ack:
            return cqi_ok
        # both slots carry the same d_ack; each must be decided right
        return cqi_ok & torch.all(acks[0] == self._ack_true, dim=-1) \
            & torch.all(acks[1] == self._ack_true, dim=-1)

    def draw(self, generator: torch.Generator):
        """One step's noise normals for `trial`, on the simulator's
        device."""
        B, dev = self.cfg.batch, self.device
        return (torch.randn(B, *self.tx_data.shape, 2, generator=generator,
                            device=dev),
                torch.randn(B, *self.tx_rs.shape, 2, generator=generator,
                            device=dev))

    def step(self, generator: torch.Generator, n0):
        return self.trial(*self.draw(generator), n0)

    def run_snr(self, snr_db: float, n_batches: int = 2, seed: int = 0):
        n0 = np.float32(10.0 ** (-snr_db / 10.0))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        ok = tot = 0
        for _ in range(n_batches):
            ok += int(self.step(gen, n0).sum())
            tot += self.cfg.batch
        return dict(snr_db=snr_db, err_rate=1.0 - ok / tot, trials=tot)


def main(argv=None):
    p = argparse.ArgumentParser(description="PUCCH error-rate sweep")
    p.add_argument("-f", "--fmt", default="1a",
                   choices=("1a", "2", "2a", "2b"))
    p.add_argument("-s", "--snr0", type=float, default=-16.0)
    p.add_argument("-S", "--snr1", type=float, default=-4.0)
    p.add_argument("--step", type=float, default=2.0)
    p.add_argument("-n", "--batches", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back)")
    a = p.parse_args(argv)
    cli_device("pucchsim", a.device)
    sim = Pucchsim(PucchsimConfig(fmt=a.fmt), device=a.device)
    rows = []
    for snr in np.arange(a.snr0, a.snr1 + 1e-9, a.step):
        r = sim.run_snr(float(snr), n_batches=a.batches)
        rows.append(r)
        print(f"SNR {snr:6.1f} dB  {a.fmt} err {r['err_rate']:.5f} "
              f"({r['trials']} trials)", flush=True)
    return rows


if __name__ == "__main__":
    main()
