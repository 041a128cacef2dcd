"""Device ms a step in the eigendecomposition of Q: cuSOLVER's float64
symmetric eigensolver (tridiagonal reduction sytrd, divide and conquer
stedc/steqr/laed, back-transform ormtr) and the helpers it launches, by
the names seen in the traced window."""

from portbench.readers import device_ms_per_step

NAMES = ("syevd", "syevj", "sytrd", "ormtr", "orgtr", "steqr", "stedc",
         "sterf", "laed", "lansy_M", "lacpy_kernel", "scale_max",
         "merge_ker", "copy_info_kernel", "xx_set_info_ker", "larft",
         "larfb", "latrd")


def read(r):
    return device_ms_per_step(r, NAMES)
