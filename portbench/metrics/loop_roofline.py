"""K5' (the batched forward sweep over L chains, csrc/loop.cu) against
its least time: the bytes and operations of each launch the loop wrapper
ran, over the device time of its kernel: loop_wide_forward_kernel at
S != 4, the S = 4 walk s4_forward_kernel at S = 4."""

from portbench.readers import roofline_pct

NAMES = ("loop_wide_forward_kernel", "s4_forward_kernel")


def read(r):
    return roofline_pct(r, ("loop",), NAMES)
