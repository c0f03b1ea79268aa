"""The plain reference of the benchmark: a frozen copy of the plain paths
of the link simulators' chain (DlsimFading, Ulsim and everything they
call), in PyTorch and NumPy, with no hand-written kernel. It imports
nothing of the program under test and takes nothing the program made: it
builds its own plans, estimator matrices and channel tables from the
configuration.

Matrix products go through `device.mm`, which rounds its operands to TF32
(10 mantissa bits, the product accumulated in float32) while
`torch.backends.cuda.matmul.allow_tf32` is on: the benchmark's control, the
reference one precision below the float32 the configurations state, on any
device.
"""
