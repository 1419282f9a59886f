"""Mean over the requests of the wall time of each request's span minus
the time some card was busy inside it, in ms: the host's share of an
edit."""

from portbench import stats


def read(run):
    view = run.trace
    if view is None or not view.spans or not view.ops:
        return None
    busy = view.busy()
    host = [(b - a) - stats.covered(busy, a, b) for a, b in view.spans]
    return sum(host) / len(host) / 1e6
