"""Tables the program uploaded and waited for per request
(utils/device.upload_shared: `device.uploads` among the counts made while
the profiler recorded) over the window's requests."""

from portbench import spans


def read(run):
    return spans.counted_per_edit(run, "device.uploads")
