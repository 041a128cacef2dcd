"""K3' + K4' in float64 (the staged forward and backward sweeps,
csrc/staged.cu)
against their least time: the bytes and operations of each sweep the
staged wrappers ran, over the device time of these kernels."""

from portbench.readers import roofline_pct

# K3': level kernels, the chain kernel and the S = 4 walk of the tree's
# top; K4': root, level and sum kernels
NAMES = ("forward_level", "forward_chain", "s4_forward_kernel",
         "backward_root", "backward_level", "backward_sum")


def read(r):
    return roofline_pct(r, ("staged",), NAMES)
