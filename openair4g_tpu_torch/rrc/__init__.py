"""RRC-lite: 36.331 system information, connection management and
PHY-config plumbing (reference: openair2/RRC/LITE/{rrc_eNB.c, rrc_UE.c}
and the MESSAGES/ ASN.1 set).

Host-side control plane — everything here configures the device-side
PHY (static maps, codec plans) exactly like the reference's
phy_config_sib1/sib2/dedicated plumbing (openair1/PHY/INIT/lte_init.c:
66-880).

A copy of openair4g_tpu/rrc/__init__.py.
"""
from .messages import (Mib, Sib1, Sib2, RrcConnectionRequest,
                       RrcConnectionSetup, RrcConnectionSetupComplete,
                       RrcConnectionReconfiguration,
                       RrcConnectionReconfigurationComplete,
                       decode_message)
from .phy_config import apply_sib2, apply_dedicated
from .enb import RrcEnb
from .ue import RrcUe

__all__ = ["Mib", "Sib1", "Sib2", "RrcConnectionRequest",
           "RrcConnectionSetup", "RrcConnectionSetupComplete",
           "RrcConnectionReconfiguration",
           "RrcConnectionReconfigurationComplete", "decode_message",
           "apply_sib2", "apply_dedicated", "RrcEnb", "RrcUe"]
