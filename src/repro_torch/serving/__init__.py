"""Serving subsystem: shared request primitives, the LM batch server,
the single-workload CIM batch service, the single-chip multi-tenant
fleet and the cross-chip cluster (2-D tenancy planner -> engine pools
-> dynamic batchers -> routers), plus Chrome-trace observability and
synthetic diurnal+bursty traffic generation."""
from .common import (BaseRequest, CimRequest, LmRequest,        # noqa: F401
                     ServiceStats)
from .server import BatchServer, Request                        # noqa: F401
from .cim_service import CimBatchService                        # noqa: F401
from .placement import (FleetPlan, TenancyPlan,                 # noqa: F401
                        TenantPlacement, TenantSpec, plan_fleet,
                        plan_tenancy)
from .engine import EnginePool, points_from_campaign            # noqa: F401
from .batcher import (DEFAULT_BUCKETS, Batch, DynamicBatcher,   # noqa: F401
                      bucket_for)
from ..obs.trace import (TraceRecorder, load_trace,             # noqa: F401
                    validate_chrome_trace)
from .traffic import TrafficModel, synthetic_trace              # noqa: F401
from .fleet import (AdmissionError, ChipFault, CimCluster,      # noqa: F401
                    CimFleet, FaultSchedule, FleetStats,
                    ReplanPolicy, TransientKernelError)
