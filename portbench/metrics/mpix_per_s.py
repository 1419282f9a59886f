"""Output pixels of every request completed in the window over the
window's time (host clock), in Mpix/s."""

from portbench import stats


def read(run):
    return stats.rate([r.pixels for r in run.records], run.window_s) / 1e6
