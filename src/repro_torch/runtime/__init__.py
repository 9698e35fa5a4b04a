"""Planning and execution of reconstructions."""

# NOTE: the autotune FUNCTION is deliberately not re-exported here — it
# would shadow the `repro_torch.runtime.autotune` submodule attribute.
# elastic.reshard_tree (the LM substrate) is not ported and stays out.
from .autotune import TunedConfig, TuningCache, resolve_config  # noqa: F401
from .executor import FleetConfig, FleetReport, StreamReport, \
    StreamingExecutor, as_fleet_config  # noqa: F401
from .fault_tolerance import FaultTolerantLoop, Heartbeat  # noqa: F401
from .elastic import remesh_plan  # noqa: F401
from .engine import TiledReconstructor  # noqa: F401
from .planner import FleetSchedule, StreamSchedule, \
    partition_steps  # noqa: F401
from .service import ReconService, ServiceStats, StreamSession  # noqa: F401
from . import telemetry  # noqa: F401
from .solvers import IterativeExecutor, SolveReport, solve  # noqa: F401
from .straggler import FleetStragglerBoard, StragglerMonitor  # noqa: F401
