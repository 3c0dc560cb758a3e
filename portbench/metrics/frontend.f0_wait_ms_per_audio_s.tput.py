"""Milliseconds the thread driving the device waited on the host F0 (the pipeline's f0_wait_s) per second of input audio."""

from portbench.program_spans import f0_wait_ms_per_audio_s as read  # noqa: F401
