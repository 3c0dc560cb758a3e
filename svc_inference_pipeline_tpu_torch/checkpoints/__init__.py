"""Checkpoint conversion and I/O: the JAX package's exports
(``svc_inference_pipeline_tpu/checkpoints/__init__.py``). Both modules
import numpy only; torch is imported where a ``.pt`` file is read or
written."""

from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import (  # noqa: F401
    convert_mapper_state_dict,
    convert_vocoder_state_dict,
    convert_whisper_state_dict,
    fold_weight_norm,
    load_mapper_params,
    load_vocoder_params,
)
from svc_inference_pipeline_tpu_torch.checkpoints.native_io import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
