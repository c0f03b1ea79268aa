"""HSS-lite: subscriber store + authentication vectors.

Reference parity: openair-cn/OPENAIRHSS (subscriber database keyed by
IMSI holding the permanent key K; S6a Authentication-Information-Answer
returning (RAND, AUTN, XRES, KASME) vectors). The AES/Milenage kernel is
replaced by epc/nas.py's deterministic SHA-256 derivation.

A copy of openair4g_tpu/epc/hss.py.
"""
from __future__ import annotations

import hashlib

from .nas import auth_vector


class Hss:
    def __init__(self):
        self._subs: dict[int, bytes] = {}

    def provision(self, imsi: int, k: bytes) -> None:
        assert len(k) == 16
        self._subs[imsi] = k

    def known(self, imsi: int) -> bool:
        return imsi in self._subs

    def authentication_info(self, imsi: int, snid: int = 0) -> dict:
        """S6a AIR/AIA: one auth vector for the subscriber."""
        k = self._subs[imsi]
        rand = hashlib.sha256(b"rand" + k + snid.to_bytes(4, "big")).digest()[:16]
        autn, xres, kasme = auth_vector(k, rand)
        return dict(rand=rand, autn=autn, xres=xres, kasme=kasme)
