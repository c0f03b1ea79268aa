from .qpp import QPP_TABLE, QPP_BY_K
from .tbs import (get_Qm, get_Qm_ul, get_I_TBS, get_I_TBS_ul,
                  get_TBS_DL, get_TBS_UL, get_G_dl)
from .modulation import mod_table, qpsk_table, qam16_table, qam64_table
