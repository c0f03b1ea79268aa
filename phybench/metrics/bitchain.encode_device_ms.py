"""Device milliseconds a step of the operations (kernels, copies, fills)
whose launching call the host made inside the program's
oai4g:bitchain.encode spans: CRC24A and B, segmentation, the turbo
encoder and the rate matching of each round (phybench/spans.py)."""
from phybench import spans

HOOKS = spans.HOOKS


def read(t):
    s = spans.of(t, "bitchain.encode_device_ms", "bitchain.encode",
                 device=True)
    return None if s is None else s.device_ms("bitchain.encode")
