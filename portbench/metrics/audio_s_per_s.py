"""Seconds of input audio converted in the window over the window's wall seconds."""

from portbench.readers import audio_s_per_s as read  # noqa: F401
