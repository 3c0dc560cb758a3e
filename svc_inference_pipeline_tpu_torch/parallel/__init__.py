"""Multi-device code: one process per device on ``torch.distributed``.

Counterpart of ``svc_inference_pipeline_tpu/parallel``: ``distributed``
(process-group setup from the ``SVC_*`` variables, and ``spawn`` for local
ranks), ``mesh`` (named ``data``/``model``/``pipe`` axes), ``sharding``
(the TP rules, batch slices and the TP forwards' collectives),
``tp_vocoder`` (the overlap-save chunked vocoder), ``sp_whisper`` (the
sequence-parallel encoder) and ``pp`` (the GPipe denoiser).
"""

from svc_inference_pipeline_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from svc_inference_pipeline_tpu_torch.parallel.sharding import (  # noqa: F401
    MAPPER_TP_RULES,
    VOCODER_TP_RULES,
    WHISPER_TP_RULES,
    batch_shard,
    replicate,
    shard_params,
)
