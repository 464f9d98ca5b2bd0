"""95th percentile of the harness's span of ``CimBatchService.dispatch``
over every dispatch of the measured window: the tail a client sees,
which the host's pace sets as much as the card's."""
from cimbench import harness


def read(r):
    if not r.dispatch_s:
        return None
    return 1e3 * harness.p95(r.dispatch_s)
