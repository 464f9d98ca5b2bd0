"""Serving subsystem: shared request primitives and the single-workload
CIM batch service over the trace-lowered executor."""
from .common import (BaseRequest, CimRequest, LmRequest,        # noqa: F401
                     ServiceStats)
from .cim_service import CimBatchService                        # noqa: F401
