"""The first card's idle time inside each request, charged to the
program's kernel-wrapper spans (`pfe.kchain.*`, `pfe.kcomposite.*`,
`pfe.device.*`; the innermost open span takes it), as the mean over the
window's requests, in ms (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.idle_ms_per_edit(run, "kernels")
