"""RRC message set (36.331 subset) with a deterministic bit codec.

Reference parity: openair2/RRC/LITE/MESSAGES (the asn1c-generated 36.331
message set) and the do_SIB1/do_SIB23/do_RRCConnectionSetup builders in
openair2/RRC/LITE/rrc_eNB.c. The reference carries full ASN.1 UPER; this
framework carries the same information elements through a PER-lite
codec: a one-byte message tag, then every field packed MSB-first at its
declared fixed width, in declaration order. That keeps the control plane
byte-deterministic (goldens in tests) without an ASN.1 toolchain — the
IEs, value ranges and state machines are the capability being rebuilt,
not the transfer syntax.

All messages ride the existing stack: BCCH -> PBCH/PDSCH, CCCH -> RLC-TM,
DCCH -> RLC-AM over PDCP (mac/rlc.py, mac/pdcp.py).

A copy of openair4g_tpu/rrc/messages.py.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

# ---------------------------------------------------------------- codec --
# field spec: (name, bit width). Values are non-negative ints.


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, val: int, width: int):
        assert 0 <= val < (1 << width), (val, width)
        self.bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]

    def to_bytes(self) -> bytes:
        n = len(self.bits)
        pad = (-n) % 8
        bits = self.bits + [0] * pad
        arr = np.asarray(bits, np.uint8).reshape(-1, 8)
        return bytes(np.packbits(arr, axis=1).ravel())


class _BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def take(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v


_REGISTRY: dict[int, type] = {}


def _rrc_message(tag: int):
    """Class decorator: registers the tag and derives pack/unpack from the
    dataclass fields' `width` metadata."""
    def wrap(cls):
        cls.TAG = tag
        _REGISTRY[tag] = cls

        def pack(self) -> bytes:
            w = _BitWriter()
            w.put(tag, 8)
            for f in fields(self):
                if f.metadata.get("bytes"):
                    val = getattr(self, f.name)
                    w.put(len(val), 16)
                    for byte in val:
                        w.put(byte, 8)
                else:
                    w.put(int(getattr(self, f.name)), f.metadata["width"])
            return w.to_bytes()

        @classmethod
        def unpack(kls, data: bytes):
            r = _BitReader(data)
            t = r.take(8)
            assert t == tag, (t, tag)
            vals = {}
            for f in fields(kls):
                if f.metadata.get("bytes"):
                    n = r.take(16)
                    vals[f.name] = bytes(r.take(8) for _ in range(n))
                else:
                    vals[f.name] = r.take(f.metadata["width"])
            return kls(**vals)

        cls.pack = pack
        cls.unpack = unpack
        return cls
    return wrap


def _f(width: int, default: int = 0):
    from dataclasses import field
    return field(default=default, metadata={"width": width})


def _b(default: bytes = b""):
    """Variable-length bytes field (16-bit length prefix) — the octet-
    string containers of 36.331 (dedicatedInfoNAS etc.)."""
    from dataclasses import field
    return field(default=default, metadata={"bytes": True})


def decode_message(data: bytes):
    """Tag-dispatched decode of any registered RRC message."""
    tag = data[0]
    if tag not in _REGISTRY:
        raise ValueError(f"unknown RRC message tag {tag}")
    return _REGISTRY[tag].unpack(data)


# ------------------------------------------------------------- messages --

@_rrc_message(0x01)
@dataclass
class Mib:
    """MasterInformationBlock. The on-air MIB rides PBCH via
    phy/pbch.py:pack_mib; this wrapper exists so the RRC layer speaks the
    same message API for all broadcast information."""
    bw_index: int = _f(3)          # {6,15,25,50,75,100} RB index
    phich_duration: int = _f(1)
    phich_resource: int = _f(2)
    sfn_msb8: int = _f(8)


@_rrc_message(0x02)
@dataclass
class Sib1:
    """SystemInformationBlockType1: PLMN/cell identity, access info and
    the scheduling of further SI (36.331 §6.2.2)."""
    mcc: int = _f(10, 1)           # 3 BCD digits
    mnc: int = _f(10, 1)
    tracking_area_code: int = _f(16)
    cell_identity: int = _f(28)
    cell_barred: int = _f(1)       # 0 = notBarred
    intra_freq_reselection: int = _f(1)
    q_rx_lev_min: int = _f(6)      # -Q/2 dBm encoding (range -70..-22)
    freq_band_indicator: int = _f(6, 7)
    si_window_length: int = _f(3)  # {1,2,5,10,15,20,40} ms index
    si_periodicity: int = _f(3)    # SIB2 period: 2^(3+idx) frames
    tdd_config: int = _f(3)        # 0-6; FDD cells carry 0 + fdd flag
    is_fdd: int = _f(1, 1)
    system_info_value_tag: int = _f(5)


@_rrc_message(0x03)
@dataclass
class Sib2:
    """SystemInformationBlockType2: radioResourceConfigCommon + UL config
    (36.331 §6.2.2) — everything phy_config_sib2_eNB/UE consumes
    (openair1/PHY/INIT/lte_init.c:190-470)."""
    # rach-ConfigCommon
    n_ra_preambles: int = _f(6, 52)        # numberOfRA-Preambles
    power_ramping_step_db: int = _f(2, 1)  # {0,2,4,6} dB
    preamble_init_target_pwr: int = _f(4, 5)   # -120+2i dBm
    preamble_trans_max: int = _f(4, 6)     # {3..200} table index
    ra_response_window: int = _f(3, 7)     # {2..10} sf
    mac_contention_timer: int = _f(3, 5)   # {8..64} sf
    max_harq_msg3_tx: int = _f(3, 4)
    # prach-Config
    prach_config_index: int = _f(6)
    prach_freq_offset: int = _f(7, 2)
    zero_correlation_zone: int = _f(4, 1)  # NCS config
    prach_root_sequence: int = _f(10)      # logical root index
    high_speed_flag: int = _f(1)
    # pdsch/pusch-ConfigCommon
    pdsch_ref_power: int = _f(7, 18)       # referenceSignalPower, offset-60
    pdsch_p_b: int = _f(2)
    pusch_n_sb: int = _f(2, 1)
    pusch_hopping_mode: int = _f(1)
    pusch_hopping_offset: int = _f(7)
    enable_64qam: int = _f(1)
    group_hopping: int = _f(1)
    group_assignment: int = _f(5)
    sequence_hopping: int = _f(1)
    cyclic_shift: int = _f(3)
    # pucch-ConfigCommon
    pucch_delta_shift: int = _f(2, 1)
    pucch_n_rb_cqi: int = _f(7, 1)
    pucch_n_cs_an: int = _f(3)
    pucch_n1_an: int = _f(11)
    # soundingRS-UL-ConfigCommon
    srs_bw_config: int = _f(3)
    srs_subframe_config: int = _f(4)
    srs_ack_nack_simultaneous: int = _f(1)
    # uplinkPowerControlCommon
    p0_nominal_pusch: int = _f(8, 85)      # -126+i dBm
    alpha: int = _f(3, 7)                  # {0,.4,.5,.6,.7,.8,.9,1}
    p0_nominal_pucch: int = _f(5, 20)      # -127+i dBm
    # ul-CarrierFreq / bandwidth
    ul_bandwidth: int = _f(3, 2)           # {6,15,25,50,75,100} RB index
    additional_spectrum_emission: int = _f(5, 1)
    # pcch-Config (36.331 §6.3.2; consumed by rrc/paging.py — the
    # reference reads defaultPagingCycle at rrc_UE.c:2303,2755)
    default_paging_cycle: int = _f(2, 1)   # rf{32,64,128,256} index
    paging_nb: int = _f(3, 2)              # nB: {4T,2T,T,T/2,T/4,...} index


@_rrc_message(0x10)
@dataclass
class RrcConnectionRequest:
    """CCCH uplink (Msg3): 40-bit random UE identity + cause."""
    ue_identity: int = _f(40)
    establishment_cause: int = _f(3)   # emergency/highPrio/mt/mo-sig/mo-data


@_rrc_message(0x11)
@dataclass
class RrcConnectionSetup:
    """CCCH downlink (Msg4): SRB1 setup + initial physicalConfigDedicated."""
    ue_identity: int = _f(40)          # echoes Msg3 (contention resolution)
    srb1_rlc_mode: int = _f(1, 1)      # 1 = AM
    srb1_t_poll_retx: int = _f(6, 10)
    srb1_t_reordering: int = _f(6, 10)
    # physicalConfigDedicated (subset)
    transmission_mode: int = _f(4, 1)
    p_a: int = _f(3, 4)                # {-6,-4.77,-3,-1.77,0,1,2,3} dB
    cqi_period_idx: int = _f(4)
    sr_config_idx: int = _f(8)


@_rrc_message(0x12)
@dataclass
class RrcConnectionSetupComplete:
    selected_plmn: int = _f(3, 1)
    # registeredMME / S-TMSI (36.331 §6.2.2): lets the eNB attach the
    # S-TMSI IE to the InitialUEMessage so the MME can find the existing
    # security context (ServiceRequest / TAU from idle); 0 = absent
    s_tmsi: int = _f(48, 0)
    # dedicatedInfoNAS: the initial NAS message (AttachRequest) rides here,
    # as in the reference (rrc_eNB.c forwards it as InitialUEMessage)
    dedicated_info_nas: bytes = _b()


@_rrc_message(0x13)
@dataclass
class RrcConnectionReconfiguration:
    """DCCH: mobility/measurement/physicalConfigDedicated update."""
    transaction_id: int = _f(2)
    transmission_mode: int = _f(4, 1)
    # srs-ConfigDedicated (subset)
    srs_enable: int = _f(1)
    srs_bw: int = _f(2)
    srs_freq_pos: int = _f(5)
    srs_config_idx: int = _f(10)
    srs_cyclic_shift: int = _f(3)
    # measConfig-lite: one intra-freq A3 event
    meas_enable: int = _f(1)
    a3_offset_db: int = _f(5, 6)       # (i-15)/2 dB
    hysteresis: int = _f(5, 2)
    time_to_trigger_ms: int = _f(4, 4) # table index
    # drb addition
    drb_add: int = _f(1)
    drb_identity: int = _f(5, 1)
    drb_rlc_mode: int = _f(1, 0)       # 0 = UM


@_rrc_message(0x14)
@dataclass
class RrcConnectionReconfigurationComplete:
    transaction_id: int = _f(2)


@_rrc_message(0x15)
@dataclass
class MeasurementReport:
    """A3-triggered report: serving + one neighbour (36.331 §5.5.5)."""
    meas_id: int = _f(3, 1)
    rsrp_serving: int = _f(7)          # 36.133 RSRP code 0..97
    rsrq_serving: int = _f(6)
    neighbour_pci: int = _f(9)
    rsrp_neighbour: int = _f(7)


@_rrc_message(0x16)
@dataclass
class RrcConnectionRelease:
    release_cause: int = _f(2)         # loadBalancing/other


@_rrc_message(0x17)
@dataclass
class DlInformationTransfer:
    """DCCH downlink NAS transport (36.331 §5.6.1; rrc_eNB.c
    rrc_eNB_generate_dedicatedInformationTransfer)."""
    dedicated_info_nas: bytes = _b()


@_rrc_message(0x18)
@dataclass
class UlInformationTransfer:
    """DCCH uplink NAS transport (36.331 §5.6.2)."""
    dedicated_info_nas: bytes = _b()


@_rrc_message(0x19)
@dataclass
class MobilityControlInfo:
    """mobilityControlInfo IE carried inside an
    RRCConnectionReconfiguration that commands handover (36.331 §6.3.4;
    the reference builds it in rrc_eNB.c:1760-1990 HO preparation)."""
    target_pci: int = _f(9)
    new_crnti: int = _f(16)
    t304_ms_idx: int = _f(3, 4)        # {50,100,150,200,500,1000,2000} idx
    ra_preamble_index: int = _f(6)     # dedicated (contention-free) RA
    ra_prach_mask: int = _f(4)
    carrier_freq: int = _f(16)


@_rrc_message(0x1A)
@dataclass
class RrcHandoverCommand:
    """RRCConnectionReconfiguration w/ mobilityControlInfo, flattened
    (the HO flavour of reconfiguration; DCCH downlink)."""
    transaction_id: int = _f(2)
    mobility: bytes = _b()             # packed MobilityControlInfo


@_rrc_message(0x1B)
@dataclass
class HandoverPreparationInformation:
    """Inter-eNB (X2/S1) container: source context for the target cell
    (36.331 §10.2.2; rrc_eNB.c HandoverPreparationInformation)."""
    ue_identity: int = _f(40)
    source_crnti: int = _f(16)
    transmission_mode: int = _f(4, 1)
    rsrp_neighbour: int = _f(7)
    as_context: bytes = _b()           # PDCP/RLC state blob (opaque)


@_rrc_message(0x1C)
@dataclass
class Paging:
    """PCCH Paging message (36.331 §6.2.2): one paging record.
    ue_identity: S-TMSI/IMSI-derived id the idle UE matches on."""
    ue_identity: int = _f(40)
    cn_domain: int = _f(1, 1)          # 1 = PS
    system_info_modification: int = _f(1)


@_rrc_message(0x1D)
@dataclass
class SecurityModeCommand:
    """AS SecurityModeCommand (36.331 §6.2.2 / rrc_eNB.c
    rrc_eNB_generate_SecurityModeCommand): selects the AS integrity +
    ciphering algorithms; the message itself is the first SRB1 PDU carrying
    a (valid) PDCP MAC-I, computed with the new K_RRCint."""
    integrity_algo: int = _f(3, 2)     # 2 = EIA2(-lite stand-in)
    ciphering_algo: int = _f(3, 0)     # 0 = EEA0 (SRBs stay unciphered)


@_rrc_message(0x1E)
@dataclass
class SecurityModeComplete:
    """UE answer once the AS keys are in place; integrity-protected."""
    transaction_id: int = _f(2)


@_rrc_message(0x1F)
@dataclass
class SecurityModeFailure:
    """UE answer when the SMC's MAC-I check failed (sent unprotected,
    36.331 §5.3.4.5)."""
    transaction_id: int = _f(2)
