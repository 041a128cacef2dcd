"""Kernel launches a step (an evaluation in the API cell) in the traced
window, from the profiler's device rows."""

from portbench.readers import launches_per_step as read  # noqa: F401
