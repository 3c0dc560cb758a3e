"""Model FLOPs of the window's conversions over the window at the bf16 peak, in percent."""

from portbench.readers import mfu as read  # noqa: F401
