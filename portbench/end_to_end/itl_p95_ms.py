"""95th percentile of every gap between consecutive output tokens of a
request, for each gap whose later token falls in the window."""
from portbench.harness import stats


def read(run):
    return stats.percentile(run.token_gaps_ms(), 95)
