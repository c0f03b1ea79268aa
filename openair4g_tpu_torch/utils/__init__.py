"""Host utilities (counterparts of openair4g_tpu.utils)."""
