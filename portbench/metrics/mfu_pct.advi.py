"""The whole step's share of the peak: the pruning operations of every
sweep the ops wrappers ran in the measured window (forward and backward,
or L chains' forward sweeps), over the window's time at 67 TFLOP/s."""

from portbench.readers import mfu_pct as read  # noqa: F401
