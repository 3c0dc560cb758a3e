"""svc_inference_pipeline_tpu_torch — the singing-voice-conversion pipeline
in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``svc_inference_pipeline_tpu`` (JAX/Pallas, the reference), with
the same module layout: ``config``, ``utils``, ``ops`` (DSP front-end, F0,
and in ``ops/pallas`` the wrappers of the CUDA kernels in ``csrc/``),
``models``, ``sampling``, ``checkpoints`` (the bridge from JAX parameter
trees), ``pipeline`` and ``cli``. It imports PyTorch and never JAX.

Main path: ``SVCPipeline.convert`` — front-end (mel energy, 24->16 kHz
resample, Whisper log-mel and encoder, hop remap; Praat F0 on a host
thread), condition encoder, 1000-step DDPM over the DiffSVC denoiser,
mel denormalisation, BigVGAN, fade and trim.
"""

__version__ = "0.1.0"

from svc_inference_pipeline_tpu_torch.config import HParams, load_config  # noqa: F401
