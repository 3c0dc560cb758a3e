"""K4: full-context self-attention of the Whisper encoder.

Counterpart of ``svc_inference_pipeline_tpu/ops/pallas/attention.py``; the
kernel is ``csrc/attention.cu``. Split-scale attention: q and k are each
scaled by hd^-0.25 (rounded to the input dtype, as the JAX wrapper does),
scores and softmax in f32, the probabilities rounded to the input dtype
after normalisation, then P@V with f32 accumulation.

CPU tensors take :func:`encoder_attention_plain`; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

HEAD_DIM = 64  # the kernel's head width (every Whisper size uses 64)


def _split_scale(hd: int, dtype) -> float:
    """hd^-0.25 rounded to ``dtype`` (``jnp.asarray(scale, q.dtype)``)."""
    return float(torch.tensor(hd ** -0.25, dtype=dtype))


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """Plain PyTorch version: q, k, v [B, T, D] -> [B, T, D] (q.dtype)."""
    b, t, d = q.shape
    hd = d // n_head
    scale = _split_scale(hd, q.dtype)

    def heads(x, s):
        x = (x.float() * s).to(x.dtype) if s != 1.0 else x
        return x.reshape(b, t, n_head, hd).transpose(1, 2).float()

    scores = heads(q, scale) @ heads(k, scale).transpose(-1, -2)  # f32
    p = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = p @ heads(v, 1.0)
    return out.transpose(1, 2).reshape(b, t, d).to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_head: int) -> torch.Tensor:
    """Unmasked self-attention of [B, T, D] q/k/v; CUDA launches are counted
    in ``encoder_attention.launches``."""
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, n_head)
    from svc_inference_pipeline_tpu_torch.ops.pallas import _build

    _build.refuse_autograd("encoder_attention", q, k, v)
    b, t, d = q.shape
    if d != n_head * HEAD_DIM:
        raise ValueError(f"encoder_attention: width {d} is not {n_head} heads x {HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.shape != q.shape or not x.is_contiguous():
            raise ValueError(
                f"encoder_attention: {name} must be contiguous bf16 {tuple(q.shape)}, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != q.device:
            raise ValueError(f"encoder_attention: {name} is on {x.device}, q on {q.device}")
    out = torch.empty_like(q)
    status = _build.lib().svc_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, n_head,
        _split_scale(HEAD_DIM, q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "svc_encoder_attention")
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
