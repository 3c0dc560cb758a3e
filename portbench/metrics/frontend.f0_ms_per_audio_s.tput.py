"""Host F0 milliseconds (the pipeline's f0_s: each clip's Praat tracker and pitch shift on the F0 thread) per second of input audio."""

from portbench.program_spans import f0_ms_per_audio_s as read  # noqa: F401
