"""The port's counterparts of the repo's campaign programs (scripts/):
the BLER campaigns and the measurement programs, run as `python3 -m
openair4g_tpu_torch.scripts.<name>` on the card (`--device cpu` for a
small run on the CPU), writing under results_torch/<name>/."""
