"""Physical-layer channels and receivers (counterparts of openair4g_tpu.phy)."""
