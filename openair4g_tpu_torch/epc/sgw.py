"""SGW/PGW-lite: bearer tunnel table + user-plane forwarding + PDN.

Reference parity: openair-cn/SGW-LITE (sgw_lite_task.c: Create/Modify
Session handling, per-bearer S1-U TEID allocation, GTP-U forwarding) and
the collapsed PGW (IP address pool, SGi). The "PDN" here is an in-process
endpoint the test can program (default: echo), standing in for the SGi
interface.

A copy of openair4g_tpu/epc/sgw.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .gtpu import gtpu_encap, gtpu_decap, GTPU_GPDU, GTPU_ECHO_REQ, \
    GTPU_ECHO_RSP


@dataclass
class Bearer:
    imsi: int
    ebi: int
    ue_ipv4: int
    sgw_teid_ul: int          # eNB -> SGW tunnel id (we allocated)
    enb_teid_dl: int = 0      # SGW -> eNB tunnel id (eNB allocated)
    enb_addr: int = 0
    qci: int = 9              # default bearer: non-GBR QCI 9
    linked_ebi: int = 0       # dedicated bearers link to a default EBI
    tft_dport: int = 0        # DL TFT: UDP destination port (0 = none)


class SgwPgw:
    """S11-lite control (create/modify session) + S1-U user plane."""

    def __init__(self, ip_pool_base: int = 0x0C000002):   # 12.0.0.2+
        self._bearers_by_teid: dict[int, Bearer] = {}
        self._bearers_by_ip: dict[int, Bearer] = {}          # default bearer
        self._dedicated_by_ip: dict[int, list] = {}          # TFT bearers
        self._next_teid = 0x1000
        self._next_ip = ip_pool_base
        self.dl_queue: list[bytes] = []        # GTP-U PDUs toward the eNB
        self._dl_age: dict[int, int] = {}      # poll count per queued PDU
        self.pdn_handler = lambda ue_ip, pkt: pkt   # SGi: default echo

    # ------------------------------------------------------- S11 control --
    def create_session(self, imsi: int, ebi: int) -> Bearer:
        """S11 Create Session Request -> allocate UE IP + S1-U UL TEID."""
        b = Bearer(imsi=imsi, ebi=ebi, ue_ipv4=self._next_ip,
                   sgw_teid_ul=self._next_teid)
        self._next_ip += 1
        self._next_teid += 1
        self._bearers_by_teid[b.sgw_teid_ul] = b
        self._bearers_by_ip[b.ue_ipv4] = b
        return b

    def create_dedicated_bearer(self, linked_teid_ul: int, ebi: int,
                                qci: int, tft_dport: int) -> Bearer:
        """Dedicated bearer on an existing PDN connection (reference
        SGW-LITE Create Bearer): same UE IP, own S1-U tunnel pair, DL
        traffic steered by the TFT's UDP destination port."""
        parent = self._bearers_by_teid[linked_teid_ul]
        b = Bearer(imsi=parent.imsi, ebi=ebi, ue_ipv4=parent.ue_ipv4,
                   sgw_teid_ul=self._next_teid, qci=qci,
                   linked_ebi=parent.ebi, tft_dport=tft_dport)
        self._next_teid += 1
        self._bearers_by_teid[b.sgw_teid_ul] = b
        self._dedicated_by_ip.setdefault(b.ue_ipv4, []).append(b)
        return b

    def delete_dedicated_bearer(self, sgw_teid_ul: int) -> None:
        b = self._bearers_by_teid.pop(sgw_teid_ul, None)
        if b is not None:
            sibs = self._dedicated_by_ip.get(b.ue_ipv4, [])
            if b in sibs:
                sibs.remove(b)

    def modify_bearer(self, sgw_teid_ul: int, enb_teid_dl: int,
                      enb_addr: int) -> None:
        """S11 Modify Bearer: learn the eNB's DL endpoint (completes the
        tunnel after InitialContextSetupResponse)."""
        b = self._bearers_by_teid[sgw_teid_ul]
        b.enb_teid_dl = enb_teid_dl
        b.enb_addr = enb_addr

    def release_access_bearers(self, sgw_teid_ul: int) -> None:
        """S11 Release Access Bearers (ECM-IDLE): forget the eNB DL
        endpoint; the session + UE IP survive for paging-triggered
        re-establishment."""
        b = self._bearers_by_teid[sgw_teid_ul]
        b.enb_teid_dl = 0
        b.enb_addr = 0

    def delete_session(self, sgw_teid_ul: int) -> None:
        """S11 Delete Session (detach): tear the bearer down and return
        the UE IP to the pool's dead list."""
        b = self._bearers_by_teid.pop(sgw_teid_ul, None)
        if b is not None:
            self._bearers_by_ip.pop(b.ue_ipv4, None)
            # a PDN connection takes its dedicated bearers down with it
            for d in self._dedicated_by_ip.pop(b.ue_ipv4, []):
                self._bearers_by_teid.pop(d.sgw_teid_ul, None)

    # -------------------------------------------------------- user plane --
    @staticmethod
    def _udp_dport(pkt: bytes) -> int | None:
        """UDP destination port of a minimal IPv4/UDP packet (None if the
        payload isn't one — non-IP test payloads ride the default
        bearer)."""
        if len(pkt) < 28 or (pkt[0] >> 4) != 4 or pkt[9] != 17:
            return None
        ihl = (pkt[0] & 0xF) * 4
        if len(pkt) < ihl + 4:
            return None
        return (pkt[ihl + 2] << 8) | pkt[ihl + 3]

    def _dl_bearer(self, ue_ipv4: int, pkt: bytes) -> Bearer:
        """TFT routing: a dedicated bearer whose DL filter matches the
        packet's UDP destination port wins; otherwise the default bearer
        (24.301: the default bearer carries non-matching traffic)."""
        dport = self._udp_dport(pkt)
        if dport is not None:
            for b in self._dedicated_by_ip.get(ue_ipv4, []):
                if b.tft_dport == dport:
                    return b
        return self._bearers_by_ip[ue_ipv4]

    def handle_uplink(self, gtpu_pdu: bytes) -> bytes | None:
        """eNB -> SGW S1-U PDU. G-PDUs go to the PDN; the PDN's response
        (echo by default) is encapsulated downlink. Echo Requests get an
        Echo Response (returned directly)."""
        msg_type, teid, payload = gtpu_decap(gtpu_pdu)
        if msg_type == GTPU_ECHO_REQ:
            return gtpu_encap(teid, b"", GTPU_ECHO_RSP)
        assert msg_type == GTPU_GPDU, msg_type
        b = self._bearers_by_teid[teid]
        resp = self.pdn_handler(b.ue_ipv4, payload)
        if resp is not None:
            rb = self._dl_bearer(b.ue_ipv4, resp)      # TFT routing
            assert rb.enb_teid_dl, "downlink tunnel not established"
            self.dl_queue.append(gtpu_encap(rb.enb_teid_dl, resp))
        return None

    def requeue_unclaimed(self, keep: list, max_age: int = 64) -> None:
        """Re-queue DL PDUs no eNB claimed this poll, ageing each one out
        after `max_age` polls (ADVICE r3: PDUs for dead tunnels — e.g. a
        UE context dropped by RLF — must not be rescanned forever)."""
        kept, ages = [], {}
        for pdu in keep:
            age = self._dl_age.get(id(pdu), 0) + 1
            if age < max_age:
                ages[id(pdu)] = age
                kept.append(pdu)
        self._dl_age = ages
        self.dl_queue = kept

    def send_downlink(self, ue_ipv4: int, pkt: bytes) -> None:
        """PDN-originated downlink packet toward a UE IP (TFT-routed)."""
        b = self._dl_bearer(ue_ipv4, pkt)
        assert b.enb_teid_dl, "downlink tunnel not established"
        self.dl_queue.append(gtpu_encap(b.enb_teid_dl, pkt))
