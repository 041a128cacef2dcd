"""Host-device synchronizations a step: the program's ``physher.sync*``
spans in the traced window."""

from portbench.spans import host_syncs_per_step as read  # noqa: F401
