"""K-chain's share of its roofline: the least time of each request's
chain (counts/kchain.py, the whole image) over the device time of K-chain's
launches (csrc/fused_chain.cu), summed over the cards."""

from portbench import roofline

KERNELS = ("chain_tiled_kernel", "chain_tail_kernel")


def read(run):
    return roofline.share(run, KERNELS, "kchain")
