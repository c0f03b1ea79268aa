"""Link-level simulators (counterparts of openair4g_tpu.sim)."""
