"""K-composite's share of its roofline: the least time of each request's
fold (counts/kcomposite.py) over the device time of K-composite's launches
(csrc/composite.cu), summed over the cards."""

from portbench import roofline

KERNELS = ("composite_kernel",)


def read(run):
    return roofline.share(run, KERNELS, "kcomposite")
