"""Bytes the program's spatial layer copied per request, counted at the
copies (`spatial.copy_bytes.*` among the counts made while the profiler
recorded) over the window's requests, in MB (1e6 bytes)."""

from portbench import spans


def read(run):
    n = spans.counted_per_edit(run, "spatial.copy_bytes.")
    return None if n is None else n / 1e6
