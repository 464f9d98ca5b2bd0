"""Give each pytest-xdist worker its share of the host's cores.

Six workers, each with torch's default pool of one thread per core, ran
48 compute threads on an 8-core host.  A worker's threads are set
before torch starts its pool, in the environment too, so the processes
that tests start inherit them.  A caller who set either variable keeps
both (torch takes ``MKL_NUM_THREADS`` over ``OMP_NUM_THREADS``); a serial
run and xdist's controller, whose environment the workers inherit, are
left alone.
"""
import os

_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
#: the threads this file gave the worker, or ``None`` where it set nothing
THREADS = (max(1, len(os.sched_getaffinity(0)) // int(_WORKERS))
           if _WORKERS and not any(v in os.environ for v in _VARS)
           else None)
if THREADS:
    os.environ.update(dict.fromkeys(_VARS, str(THREADS)))


def pytest_configure(config):
    if THREADS:
        import torch
        torch.set_num_threads(THREADS)
