"""MAC layer: PF scheduler, HARQ bookkeeping, random access.

A copy of openair4g_tpu/mac/__init__.py.
"""
from .scheduler import PfScheduler, UeContext, Allocation, CQI_TO_MCS  # noqa
from .ra import (Rar, pack_rar, unpack_rar, ra_rnti,                   # noqa
                 timing_advance_from_delay, RaProcedure)
from .rlc import RlcUm, RlcAm, UmPdu, AmPdu, StatusPdu                 # noqa
from .pdcp import PdcpEntity, PdcpConfig                               # noqa
