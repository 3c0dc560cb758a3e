"""Clips per device batch: the server's conversions over its batches in the window."""

from portbench.readers import batch_mean as read  # noqa: F401
