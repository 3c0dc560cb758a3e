"""Share of the traced sub-window in which no device operation ran, in percent."""

from portbench.readers import device_idle as read  # noqa: F401
