"""Share of the traced window in which the device ran no kernel, copy or
fill (one minus the union of their intervals over the window)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
