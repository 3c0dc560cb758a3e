"""BigVGAN's bound time over the vocoder time (vocoder_s), in percent."""

from portbench.readers import vocoder_roofline as read  # noqa: F401
