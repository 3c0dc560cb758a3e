"""Training: the diffusion (mapper) and GAN (vocoder) objectives, their loop,
data loader and elastic supervisor (the JAX package's exports,
``svc_inference_pipeline_tpu/training/__init__.py``)."""

from svc_inference_pipeline_tpu_torch.training.diffusion import (  # noqa: F401
    DiffusionTrainState,
    init_diffusion_train_state,
    make_diffusion_train_step,
)
