"""Per-TTI PHY procedures (the reference's openair1/SCHED layer;
counterpart of openair4g_tpu.sched)."""
from .enb_tx import CellConfig, EnbTx                      # noqa: F401
from .ue_rx import UeRx                                    # noqa: F401
from .ue_tx import UeUlConfig, UeTx                        # noqa: F401
from .enb_rx import EnbRx, HarqFeedbackState               # noqa: F401
