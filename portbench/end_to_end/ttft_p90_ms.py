"""90th percentile of the time from each request's due time to its first
token, over every request due in the window that got one (a request that
got none within the drain counts as failed)."""
from portbench.harness import stats


def read(run):
    return stats.percentile(run.ttft_ms(), 90)
