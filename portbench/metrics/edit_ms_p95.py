"""The 95th percentile (nearest rank) of every request's time in the
window, from its call to the end of its work on the first card (CUDA
events around the call), in ms."""

from portbench import stats


def read(run):
    return stats.percentile([r.latency_ms for r in run.records], 95) if run.records else None
