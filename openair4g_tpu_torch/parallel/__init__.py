from .mesh import make_mesh  # noqa: F401
from .sweep import ShardedSweep  # noqa: F401
from .timeshard import sharded_pss_correlate  # noqa: F401
