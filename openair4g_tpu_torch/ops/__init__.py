"""Bit-level and symbol-level operators (counterparts of openair4g_tpu.ops)."""
