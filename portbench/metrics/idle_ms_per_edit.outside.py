"""The first card's idle time inside each request while none of the
program's spatial or kernel spans is open (the caller's own code), as the
mean over the window's requests, in ms (portbench/spans.py).  With the
other two parts it sums to edit_host_ms on one card."""

from portbench import spans


def read(run):
    return spans.idle_ms_per_edit(run, "outside")
