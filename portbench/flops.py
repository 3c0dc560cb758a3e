"""Work counts of the conversion's layers, from the algorithm's shapes at a
clip's true frame count, and the card's published peaks.

The counts are of the algorithm, not of a kernel: the matrix products of
each layer at the clip's own length (so padding to a bucket or a batch
shows as waste), the weights read once per pass, the layer's inputs read
once and its outputs written once. A bound is the larger of the operations
over the bf16 tensor-core peak and the bytes over the memory bandwidth.
Elementwise work (activations, the sampler's update) is not counted, so a
bound is never above the least time the card could take.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BF16, F32 = 2, 4
WHISPER_FRAMES_PER_S = 50  # encoder frames per second of audio
WHISPER_MEL_PER_S = 100  # log-mel frames per second of audio


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


# -- sampling: the DiffSVC denoiser -----------------------------------------

def denoiser_eval_flops(frames: int, mcfg: dict) -> float:
    """One evaluation: per layer the 3-tap dilated conv C -> 2C (12 C^2 a
    frame) and the output projection C -> 2C (4 C^2)."""
    c, n_layers = mcfg["residual_channels"], mcfg["residual_layer_num"]
    return 16.0 * frames * c * c * n_layers


def denoiser_cond_flops(frames: int, mcfg: dict) -> float:
    """The conditioner projections D -> 2C of every layer, once a conversion."""
    return 4.0 * frames * mcfg["conditioner_size"] * mcfg["residual_channels"] * mcfg["residual_layer_num"]


def denoiser_eval_bytes(frames: int, mcfg: dict) -> float:
    """One evaluation: the layers' conv and output weights (bf16), the
    conditioner projections read, the noisy mel read and eps written (f32)."""
    c, n_layers, m = mcfg["residual_channels"], mcfg["residual_layer_num"], mcfg["n_mel"]
    weights = n_layers * (3 * c * 2 * c + c * 2 * c) * BF16
    return weights + frames * (n_layers * 2 * c * BF16 + 2 * m * F32)


def sampler_evals(sampler: str, speedup: int, steps: int) -> int:
    """Denoiser evaluations of a conversion: DDPM one a step; PLMS one a
    strided step plus the warm-up's second."""
    if sampler == "ddpm":
        return steps
    if sampler == "plms":
        return len(range(0, steps, speedup)) + 1
    raise ValueError(f"no count for sampler {sampler!r}")


def sampling_bound_s(frames: int, evals: int, mcfg: dict) -> float:
    """Least time of a batch's sampling, ``frames`` summed over its clips
    (the weights are read once an evaluation for the whole batch)."""
    per_eval = bound_s(denoiser_eval_flops(frames, mcfg), denoiser_eval_bytes(frames, mcfg))
    return evals * per_eval + denoiser_cond_flops(frames, mcfg) / PEAK_BF16_FLOPS


def sampling_flops(frames: int, evals: int, mcfg: dict) -> float:
    return evals * denoiser_eval_flops(frames, mcfg) + denoiser_cond_flops(frames, mcfg)


# -- vocoder: BigVGAN -------------------------------------------------------

def _vocoder_layers(frames: int, vcfg: dict):
    """(flops, weight count, output samples) of the generator's convs at ``frames``."""
    ch, t = vcfg["upsample_initial_channel"], frames
    flops = 2.0 * t * vcfg["input_dim"] * ch * 7
    params = vcfg["input_dim"] * ch * 7
    per_stage = sum(2 * len(d) * k for k, d in zip(vcfg["resblock_kernel_sizes"], vcfg["resblock_dilation_sizes"]))
    for u, k in zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"]):
        c_in, ch = ch, ch // 2
        flops += 2.0 * t * k * c_in * ch  # transposed conv: each input sample meets k taps
        params += k * c_in * ch
        t *= u
        flops += 2.0 * t * ch * ch * per_stage
        params += ch * ch * per_stage
    flops += 2.0 * t * ch * 7
    params += ch * 7
    return flops, params, t


def vocoder_flops(frames: int, vcfg: dict) -> float:
    return _vocoder_layers(frames, vcfg)[0]


def vocoder_bound_s(frames: int, vcfg: dict) -> float:
    """Least time to vocode ``frames`` (summed over a batch, which reads the
    weights once)."""
    flops, params, samples = _vocoder_layers(frames, vcfg)
    nbytes = params * BF16 + frames * vcfg["input_dim"] * F32 + samples * F32
    return bound_s(flops, nbytes)


# -- front-end: the Whisper encoder -------------------------------------------

def whisper_flops(seconds: float, dims: dict) -> float:
    """Encoder work over ``seconds`` of audio at 50 frames a second: the
    stem's two convs, and per layer 24 n d^2 (q, k, v, out and the 4d MLP)
    plus 4 n^2 d (scores and weighted sum)."""
    d, n_mels = dims["n_audio_state"], dims["n_mels"]
    n = seconds * WHISPER_FRAMES_PER_S
    stem = 2.0 * seconds * WHISPER_MEL_PER_S * n_mels * d * 3 + 2.0 * n * d * d * 3
    return stem + dims["n_audio_layer"] * (24.0 * n * d * d + 4.0 * n * n * d)


def conversion_flops(seconds: float, frames: int, evals: int, cfg: dict) -> float:
    """Model work of one clip's conversion: Whisper, the content projection,
    the sampler's denoiser evaluations and the vocoder."""
    mcfg = cfg["mapper"]
    content = 2.0 * frames * cfg["whisper_dims"]["n_audio_state"] * mcfg["encoder_content_dim"]
    return (whisper_flops(seconds, cfg["whisper_dims"]) + content + sampling_flops(frames, evals, mcfg)
            + vocoder_flops(frames, cfg["vocoder"]))
