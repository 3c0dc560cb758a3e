"""The denoiser's bound time over the sampling time (ddpm_s), in percent."""

from portbench.readers import denoiser_roofline as read  # noqa: F401
