"""Device time of the copies that the spatial layer makes on the cards per
request, in ms: copies within a card and between cards (the join, the
blocks) and ATen's cat kernels (a block's halo rows, the overlay's zero
rows).  0 where the trace holds device work and none of these."""

COPIES = ("Memcpy DtoD", "Memcpy PtoP")
CAT = "CatArrayBatchedCopy"


def read(run):
    view = run.trace
    if view is None or not view.spans or not view.ops:
        return None
    spent = sum(op.seconds for op in view.in_window()
                if op.name.startswith(COPIES) or CAT in op.name)
    return 1e3 * spent / len(view.spans)
