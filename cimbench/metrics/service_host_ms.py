"""Host milliseconds a dispatch spends in the service around the
executor: the harness's span of ``CimBatchService.dispatch`` less the
executor's own ``executor_dispatch_s`` (recorded in
``Executor.run_batch``), per dispatch of the measured window."""


def read(r):
    if r.executor_dispatch is None:
        return None
    spent, n = r.executor_dispatch
    if n != r.dispatches or not n:
        return None
    return 1e3 * (sum(r.dispatch_s) - spent) / n
