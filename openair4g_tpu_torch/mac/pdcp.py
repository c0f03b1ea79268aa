"""PDCP: sequence numbering, header compression hook, ciphering hook,
in-order delivery (36.323).

Reference parity: openair2/LAYER2/PDCP_v10.1.0/pdcp.c (SN/HFN "COUNT"
maintenance, pdcp_data_req/ind) — the ROHC hook and the EEA ciphering hook
are interfaces there too (openair-cn SECU provides the real EEA1/2); here
EEA0 (null) is implemented and a deterministic XOR keystream stands in for
simulation (NOT cryptographic — marked as such).

A copy of openair4g_tpu/mac/pdcp.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _keystream(key: int, count: int, bearer: int, length: int) -> bytes:
    """Deterministic keystream for link simulation (stand-in for EEA2;
    NOT cryptographically secure — do not use outside simulators)."""
    rng = np.random.default_rng((key * 2654435761 + count * 40503
                                 + bearer) & 0xFFFFFFFF)
    return rng.integers(0, 256, length, dtype=np.uint8).tobytes()


def _xor(a: bytes, b: bytes) -> bytes:
    return (np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)
            ).tobytes()


@dataclass
class PdcpConfig:
    sn_bits: int = 12              # 5 (SRB), 7 or 12 (DRB) (36.323 §6.3.2)
    bearer: int = 1
    ciphering: str = "none"        # "none" (EEA0) | "xor" (sim stand-in)
    key: int = 0
    rohc: bool = False             # ROHC-lite UDP/IP compression (mac/rohc)
    integrity: bool = False        # SRB MAC-I trailer (36.323 §6.2.2);
    #   EIA-lite via epc/security.eia_mac once a key is armed/activated
    direction: int = 0             # 0 = uplink, 1 = downlink (TX sense)


class PdcpEntity:
    """One direction of a PDCP entity (DRB, or SRB with `integrity`).

    SRB integrity life cycle (mirrors 36.331 §5.3.4: the AS
    SecurityModeCommand is the first PDU protected with the new keys):
      * off   — PDUs carry an all-zero MAC-I field; RX accepts anything.
      * armed — `arm_rx(key)`: the key is known but activation hasn't been
        signalled. Zero-MAC PDUs are still accepted; the first PDU with a
        VALID MAC-I flips the entity to `on`. An invalid non-zero MAC is
        discarded.
      * on    — `activate_tx(key)` (TX) / first valid MAC (RX): every TX
        PDU is protected; every RX PDU must verify or is discarded
        (`int_failures` counts them — pdcp.c integrity-failure parity).
    """

    def __init__(self, cfg: PdcpConfig = PdcpConfig()):
        self.cfg = cfg
        self.mod = 1 << cfg.sn_bits
        self.tx_sn = 0
        self.tx_hfn = 0
        self.rx_sn = -1            # last received SN
        self.rx_hfn = 0
        self.delivered: list[bytes] = []
        self._int_key = b""
        self._tx_protect = False
        self._rx_state = "off"     # off | armed | on
        self.int_failures = 0
        if cfg.rohc:
            from .rohc import RohcCompressor, RohcDecompressor
            self._rohc_c = RohcCompressor()
            self._rohc_d = RohcDecompressor()

    # ------------------------------------------------------------ security --
    def arm_rx(self, key: bytes) -> None:
        assert self.cfg.integrity
        self._int_key = key
        if self._rx_state == "off":
            self._rx_state = "armed"

    def activate_tx(self, key: bytes) -> None:
        assert self.cfg.integrity
        self._int_key = key
        self._tx_protect = True

    @property
    def integrity_on(self) -> bool:
        return self._tx_protect or self._rx_state == "on"

    def _mac(self, count: int, data: bytes, direction: int) -> bytes:
        from ..epc.security import eia_mac
        return eia_mac(self._int_key, count, self.cfg.bearer, direction,
                       data)

    # ------------------------------------------------------------------ TX --
    def _count(self, hfn: int, sn: int) -> int:
        return (hfn << self.cfg.sn_bits) | sn

    def data_req(self, sdu: bytes) -> bytes:
        """SDU -> PDCP PDU: 2-byte header (12-bit SN, D/C=1) or 1-byte
        header (5-bit SN, SRB) + ciphered body [+ 4-byte MAC-I trailer
        when `integrity` — all-zero until activate_tx]."""
        sn = self.tx_sn
        count = self._count(self.tx_hfn, sn)
        self.tx_sn = (self.tx_sn + 1) % self.mod
        if self.tx_sn == 0:
            self.tx_hfn += 1
        body = sdu
        if self.cfg.rohc:
            body = self._rohc_c.compress(body)
        if self.cfg.ciphering == "xor":
            body = _xor(body, _keystream(self.cfg.key, count,
                                         self.cfg.bearer, len(body)))
        if self.cfg.sn_bits == 5:
            hdr = bytes([sn & 0x1F])                 # R R R | SN(5)
        else:
            hdr = bytes([0x80 | (sn >> 8), sn & 0xFF])   # D/C=1 | SN
        if not self.cfg.integrity:
            return hdr + body
        # MAC-I over (COUNT via eia_mac, header + unciphered SDU) —
        # 36.323 §5.7: integrity input is the PDU before ciphering
        mac = (self._mac(count, hdr + sdu, self.cfg.direction)
               if self._tx_protect else b"\x00\x00\x00\x00")
        return hdr + body + mac

    # ------------------------------------------------------------------ RX --
    def data_ind(self, pdu: bytes) -> bytes | None:
        """PDU -> deciphered SDU (HFN inferred across SN wrap, 36.323
        §5.1.2.1.2); duplicates/stale PDUs and integrity failures return
        None (state only advances for accepted PDUs)."""
        if self.cfg.sn_bits == 5:
            sn, hlen = pdu[0] & 0x1F, 1
        else:
            sn, hlen = ((pdu[0] & 0x0F) << 8) | pdu[1], 2
        # infer HFN: if SN jumped backwards by more than half the space,
        # the SN counter wrapped
        hfn = self.rx_hfn
        if self.rx_sn >= 0:
            delta = (sn - self.rx_sn) % self.mod
            if delta == 0:
                return None                      # duplicate
            if sn < self.rx_sn and (self.rx_sn - sn) > self.mod // 2:
                hfn = self.rx_hfn + 1
            elif sn > self.rx_sn and (sn - self.rx_sn) > self.mod // 2:
                return None                      # stale (pre-wrap)
        count = self._count(hfn, sn)
        body = pdu[hlen:]
        mac = b""
        if self.cfg.integrity:
            body, mac = body[:-4], body[-4:]
        if self.cfg.ciphering == "xor":
            body = _xor(body, _keystream(self.cfg.key, count,
                                         self.cfg.bearer, len(body)))
        if self.cfg.integrity and self._rx_state != "off":
            # MAC over header + plain SDU, computed with the PEER's
            # direction sense (it protected with its own TX direction)
            want = self._mac(count, pdu[:hlen] + body,
                             1 - self.cfg.direction)
            if self._rx_state == "on":
                if mac != want:
                    self.int_failures += 1
                    return None                  # discard, no state change
            elif mac != b"\x00\x00\x00\x00":     # armed
                if mac == want:
                    self._rx_state = "on"        # AS security is live
                else:
                    self.int_failures += 1
                    return None
        self.rx_hfn = hfn
        self.rx_sn = sn
        if self.cfg.rohc:
            body = self._rohc_d.decompress(body)
        self.delivered.append(body)
        return body
