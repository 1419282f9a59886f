"""The share of the traced window with no kernel, copy or fill on a card,
as the mean over the cell's cards, in %."""


def read(run):
    view = run.trace
    if view is None or not view.spans or not view.ops:
        return None
    return 100.0 * sum(view.idle_share(d) for d in view.devices) / len(view.devices)
