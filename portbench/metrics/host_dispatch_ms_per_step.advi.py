"""Host ms a step in the program outside its waits on the device, from the
program's spans in the traced window (under the profiler, which slows the
host)."""

from portbench.spans import host_dispatch_ms_per_step as read  # noqa: F401
