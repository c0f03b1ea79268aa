"""EPC-lite core network: S1AP + NAS EMM/ESM + GTPv1-U + MME/SGW/HSS.

Reference parity: openair-cn/ — S1AP eNB/MME procedures
(S1AP/s1ap_eNB_nas_procedures.c, s1ap_mme_nas_procedures.c), NAS EMM
attach/authentication/security-mode and ESM default-bearer machines
(NAS/EURECOM-NAS/src/emm, /esm), MME_APP UE contexts, SGW-LITE +
GTPV1-U user-plane (GTPV1-U/gtpv1u.c), HSS subscriber store.

The transfer syntax is the same PER-lite convention as rrc/messages.py
(deterministic byte codecs, not ASN.1/asn1c); the procedures, IEs, state
machines and tunnel semantics are the capability being rebuilt. Entities
are in-process objects wired by function calls (the reference's ITTI
message passing) so a full attach + default-bearer + user-plane echo runs
inside one test process, and the byte PDUs at every interface are real.

A copy of openair4g_tpu/epc/__init__.py.
"""
from .nas import (AttachRequest, AuthenticationRequest,
                  AuthenticationResponse, SecurityModeCommand,
                  SecurityModeComplete, AttachAccept, AttachComplete,
                  ActivateDefaultBearerRequest, ActivateDefaultBearerAccept,
                  decode_nas)
from .s1ap import (S1SetupRequest, S1SetupResponse, InitialUeMessage,
                   DownlinkNasTransport, UplinkNasTransport,
                   InitialContextSetupRequest, InitialContextSetupResponse,
                   UeContextReleaseCommand, UeContextReleaseComplete,
                   decode_s1ap)
from .gtpu import gtpu_encap, gtpu_decap, GTPU_GPDU
from .hss import Hss
from .mme import Mme
from .sgw import SgwPgw
from .enb_app import EnbApp
from .ue_nas import UeNas
