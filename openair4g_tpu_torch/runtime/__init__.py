"""Native runtime: IQ ring buffer, ITTI message queues, subframe scheduler
(C++, csrc/oairt.cc) and the softmodem-lite real-time loop (counterpart
of openair4g_tpu/runtime)."""
from .native import RingBuffer, MessageQueues, SubframeScheduler  # noqa: F401
from .softmodem import SoftModem, TASK_RESULT                      # noqa: F401
