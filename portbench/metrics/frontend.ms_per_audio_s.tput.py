"""Front-end milliseconds (the pipeline's frontend_s) per second of input audio."""

from portbench.readers import frontend_ms_per_audio_s as read  # noqa: F401
