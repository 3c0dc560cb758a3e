"""CREPE pitch tracking: the net on a torch device, the torchcrepe decode
chain on the host.

Counterpart of ``svc_inference_pipeline_tpu/ops/f0_crepe.py``. The reference
chain (torchcrepe): predict with the "full" model at 16 kHz (Viterbi decode
and periodicity), median-filter the periodicity (3), zero it below -60 dB
A-weighted loudness, NaN the pitch where periodicity < threshold,
mean-filter (3), zeros for NaN, then interpolate the voiced frames onto the
mel frame grid.

* **Model** (:class:`CrepeModel`, an ``nn.Module``): six conv blocks
  (filters 32 x [32, 4, 4, 4, 8, 16] at capacity "full", 4 x at "tiny";
  kernels [512, 64, ...], the first with stride 4), each conv -> ReLU ->
  per-channel affine -> max-pool 2, on 1024-sample frames, then a linear
  classifier over the [4, C] map flattened time-major and a sigmoid: 360
  pitch bins, 20 cents apart from 1997.379 cents re 10 Hz. The affine is
  torchcrepe's BatchNorm at inference (``load_crepe_params`` folds it into
  ``scale``/``shift``); it comes after the ReLU, so it cannot be folded into
  the conv. Frames go through the net in chunks of :data:`CHUNK_FRAMES`
  (frames are independent): the first block's output at "full" is 1 MB a
  frame in f32.
* **Weights**: torchcrepe's trained ``full.pth`` is not in the repository.
  :func:`load_crepe_params` converts a torchcrepe state dict (a path, or the
  ``SVC_CREPE_WEIGHTS`` variable) into the JAX package's numpy tree, which
  the weights bridge loads; without one the extractor raises.
* **Decode** (numpy, the JAX package's copy): Viterbi over the 360 bins
  (triangular band of 12 bins), then the weighted average of cents in a
  +-4-bin window around the decoded bin; periodicity is the probability at
  the decoded bin.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

CENTS_PER_BIN = 20.0
N_BINS = 360
CENTS_OFFSET = 1997.3794084376191
FMIN_CENTS = CENTS_OFFSET
SAMPLE_RATE = 16000
WINDOW_SIZE = 1024
CHUNK_FRAMES = 512  # frames a net call: ~0.5 GB of first-block output at "full" in f32


def bins_to_cents(bins):
    return CENTS_PER_BIN * np.asarray(bins, dtype=np.float64) + CENTS_OFFSET


def cents_to_freq(cents):
    return 10.0 * 2.0 ** (np.asarray(cents, dtype=np.float64) / 1200.0)


def freq_to_cents(freq):
    return 1200.0 * np.log2(np.asarray(freq, dtype=np.float64) / 10.0)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _capacity(model: str):
    mult = {"full": 32, "tiny": 4}[model]
    return [n * mult for n in (32, 4, 4, 4, 8, 16)]


class ConvBlock(nn.Conv1d):
    """F.pad -> conv -> ReLU -> x * scale + shift (per channel) -> max-pool 2,
    on [B, C, T]."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, pad: Tuple[int, int]):
        super().__init__(c_in, c_out, kernel, stride=stride)
        self.pad = pad
        self.scale = nn.Parameter(torch.ones(c_out))
        self.shift = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(F.conv1d(F.pad(x, self.pad), self.weight, self.bias, self.stride))
        return F.max_pool1d(x * self.scale[:, None] + self.shift[:, None], 2, 2)


class CrepeModel(nn.Module):
    """Normalised frames [B, 1024] -> pitch-bin probabilities [B, 360].

    Submodules ``conv0..conv5`` (:class:`ConvBlock`) and ``classifier``, the
    JAX tree's names. torchcrepe pads (254, 254) before the first conv and
    (31, 32) before the others."""

    def __init__(self, model: str = "full"):
        super().__init__()
        self.model = model
        self.filters = _capacity(model)
        self.kernels = [512, 64, 64, 64, 64, 64]
        self.strides = [4, 1, 1, 1, 1, 1]
        in_ch = 1
        for i, (f, k, s) in enumerate(zip(self.filters, self.kernels, self.strides)):
            pad = (254, 254) if i == 0 else (k // 2 - 1, k // 2)
            setattr(self, f"conv{i}", ConvBlock(in_ch, f, k, s, pad))
            in_ch = f
        self.classifier = nn.Linear(self.filters[-1] * 4, N_BINS)  # 1024 / 4 / 2^6 = 4 positions

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :]
        for i in range(len(self.filters)):
            x = getattr(self, f"conv{i}")(x)
        # [B, C, 4] -> [B, 4, C] -> flat: time-major, as JAX's NWC and torchcrepe's permute
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def build_crepe(params=None, model: str = "full", device=None, generator=None) -> CrepeModel:
    """A :class:`CrepeModel` on ``device`` (None: the GPU) holding ``params``
    (the JAX layout: ``load_crepe_params``' or JAX's ``init_params`` tree), or
    random weights from ``generator`` (on that device) when ``params`` is
    None."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_

    device = resolve_device(device)
    with torch.device(device):
        net = CrepeModel(model)
    if params is None:
        random_init_(net, generator or torch.Generator(device=device).manual_seed(0))
    else:
        load_jax_params(net, params)
    return net.eval()


@torch.no_grad()
def crepe_probs(net: CrepeModel, frames: np.ndarray) -> np.ndarray:
    """The net on ``frames`` [N, 1024] in chunks of :data:`CHUNK_FRAMES` frames
    on the net's device -> probabilities [N, 360] (f32, on the host)."""
    device = net.classifier.weight.device
    out = [net(torch.as_tensor(frames[i: i + CHUNK_FRAMES], dtype=torch.float32, device=device)).cpu()
           for i in range(0, len(frames), CHUNK_FRAMES)]
    return torch.cat(out).numpy() if out else np.zeros((0, N_BINS), np.float32)


def load_crepe_params(path: str, model: str = "full"):
    """A torchcrepe ``full.pth``/``tiny.pth`` state dict -> the JAX layout
    (numpy): ``conv{i}/{kernel [k, Cin, Cout], bias, scale, shift}`` and
    ``classifier/{kernel [in, out], bias}``. BatchNorm becomes the affine
    scale = gamma / sqrt(var + 1e-5), shift = beta - mean * scale; conv
    kernels may be 2-D ([out, in, k, 1]) as in torchcrepe's releases."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params = {}
    for i in range(6):
        w = sd[f"conv{i + 1}.weight"].numpy()
        b = sd[f"conv{i + 1}.bias"].numpy()
        gamma = sd[f"conv{i + 1}_BN.weight"].numpy()
        beta = sd[f"conv{i + 1}_BN.bias"].numpy()
        mean = sd[f"conv{i + 1}_BN.running_mean"].numpy()
        var = sd[f"conv{i + 1}_BN.running_var"].numpy()
        scale = gamma / np.sqrt(var + 1e-5)
        shift = beta - mean * scale
        if w.ndim == 4:
            w = w[..., 0]
        params[f"conv{i}"] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 1, 0)).astype(np.float32),
            "bias": b.astype(np.float32),
            "scale": scale.astype(np.float32),
            "shift": shift.astype(np.float32),
        }
    params["classifier"] = {
        "kernel": np.ascontiguousarray(sd["classifier.weight"].numpy().T).astype(np.float32),
        "bias": sd["classifier.bias"].numpy().astype(np.float32),
    }
    return params


# ---------------------------------------------------------------------------
# preprocessing / decode / filters (torchcrepe contract), numpy on the host
# ---------------------------------------------------------------------------


def frame_audio(audio16k: np.ndarray, hop_length: int) -> np.ndarray:
    """Centred 1024-sample frames every ``hop_length``, each mean-removed and
    divided by its sample std (ddof 1, as torch.std)."""
    x = np.asarray(audio16k, dtype=np.float32)
    n_frames = 1 + len(x) // hop_length
    xp = np.pad(x, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    idx = np.arange(WINDOW_SIZE)[None, :] + hop_length * np.arange(n_frames)[:, None]
    idx = np.minimum(idx, len(xp) - 1)
    frames = xp[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    std = frames.std(axis=1, keepdims=True, ddof=1)
    return frames / np.maximum(std, 1e-10)


def viterbi_decode(probs: np.ndarray, f0_min: float = 50.0, f0_max: float = 2006.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Viterbi over the 360 bins -> (f0 Hz, periodicity). Transition: a
    triangular band of width 12 bins; observation: the net's probabilities
    normalised per frame, restricted to bins within [f0_min, f0_max]. The
    decoded bin is refined by the weighted average of cents in a +-4-bin
    window; periodicity is the probability at the decoded bin."""
    probs = np.asarray(probs, dtype=np.float64)
    n_frames = len(probs)

    cents = bins_to_cents(np.arange(N_BINS))
    freqs = cents_to_freq(cents)
    allowed = (freqs >= f0_min) & (freqs <= f0_max)

    obs = probs / np.maximum(probs.sum(axis=1, keepdims=True), 1e-12)
    with np.errstate(divide="ignore"):
        lobs = np.log(np.maximum(obs, 1e-12))
    lobs[:, ~allowed] = -1e30

    width = 12
    offs = np.arange(-width, width + 1)
    tri = (width + 1 - np.abs(offs)).astype(np.float64)
    tri /= tri.sum()
    ltri = np.log(tri)

    delta = np.full(N_BINS, -np.log(N_BINS)) + lobs[0]
    ptr = np.zeros((n_frames, N_BINS), dtype=np.int32)
    for t in range(1, n_frames):
        best = np.full(N_BINS, -1e30)
        arg = np.zeros(N_BINS, dtype=np.int32)
        for off, lt in zip(offs, ltri):
            lo, hi = max(0, -off), N_BINS - max(0, off)
            if lo >= hi:
                continue
            cand = delta[lo + off: hi + off] + lt
            seg = slice(lo, hi)
            upd = cand > best[seg]
            best[seg] = np.where(upd, cand, best[seg])
            arg[seg] = np.where(upd, np.arange(lo + off, hi + off), arg[seg])
        delta = best + lobs[t]
        ptr[t] = arg

    path = np.zeros(n_frames, dtype=np.int64)
    path[-1] = int(delta.argmax())
    for t in range(n_frames - 2, -1, -1):
        path[t] = ptr[t + 1, path[t + 1]]

    f0 = np.zeros(n_frames)
    pd = np.zeros(n_frames)
    for t in range(n_frames):
        b = path[t]
        lo, hi = max(0, b - 4), min(N_BINS, b + 5)
        w = probs[t, lo:hi]
        c = (w * cents[lo:hi]).sum() / np.maximum(w.sum(), 1e-12)
        f0[t] = float(cents_to_freq(c))
        pd[t] = probs[t, b]
    return f0, pd


def median_filter(x: np.ndarray, win: int = 3) -> np.ndarray:
    """Windowed median, the windows shrinking at the edges."""
    h = win // 2
    out = np.empty_like(x, dtype=np.float64)
    for i in range(len(x)):
        out[i] = np.median(x[max(0, i - h): i + h + 1])
    return out


def mean_filter(x: np.ndarray, win: int = 3) -> np.ndarray:
    """Windowed mean, the windows shrinking at the edges (NaN spreads)."""
    h = win // 2
    out = np.empty_like(x, dtype=np.float64)
    for i in range(len(x)):
        out[i] = np.mean(x[max(0, i - h): i + h + 1])
    return out


def a_weighted_loudness(audio16k: np.ndarray, hop_length: int) -> np.ndarray:
    """Per-frame A-weighted loudness in dB on the frame grid of
    :func:`frame_audio`: a 1024-point STFT, A-weighted, the loudest bin of
    each frame against a full-scale sine."""
    x = np.asarray(audio16k, dtype=np.float64)
    n_frames = 1 + len(x) // hop_length
    xp = np.pad(x, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    idx = np.arange(WINDOW_SIZE)[None, :] + hop_length * np.arange(n_frames)[:, None]
    idx = np.minimum(idx, len(xp) - 1)
    raw = xp[idx] * np.hanning(WINDOW_SIZE)

    spec = np.abs(np.fft.rfft(raw, axis=1))
    freqs = np.fft.rfftfreq(WINDOW_SIZE, 1.0 / SAMPLE_RATE)
    fsq = np.square(np.maximum(freqs, 1e-6))
    ra = (
        12194.0**2 * np.square(fsq)
        / ((fsq + 20.6**2) * np.sqrt((fsq + 107.7**2) * (fsq + 737.9**2)) * (fsq + 12194.0**2))
    )
    a_db = 2.0 + 20.0 * np.log10(np.maximum(ra, 1e-30))
    db = 20.0 * np.log10(np.maximum(spec, 1e-10)) + a_db[None, :]
    ref = 20.0 * np.log10(WINDOW_SIZE / 2)
    # the loudest band decides: a mean over bins would drown one strong
    # partial in the -100 dB floor of the other bins
    return np.clip(db - ref, -100.0, None).max(axis=1)


# ---------------------------------------------------------------------------
# the reference chain
# ---------------------------------------------------------------------------

_PARAM_CACHE = {}


def crepe_predict(
    audio16k: np.ndarray,
    hop_length: int,
    f0_min: float,
    f0_max: float,
    model: str = "full",
    params=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(f0, periodicity) on the 16 kHz hop grid; the net runs on ``device``
    (None: the GPU). ``params`` is a JAX-layout tree; without it the
    torchcrepe file named by ``SVC_CREPE_WEIGHTS`` is converted once and
    cached."""
    if params is None:
        path = os.environ.get("SVC_CREPE_WEIGHTS", "")
        if not path or not os.path.exists(path):
            raise NotImplementedError(
                "CREPE weights unavailable: torchcrepe's trained checkpoint is not in the repository. "
                "Provide a torchcrepe full.pth via SVC_CREPE_WEIGHTS or the params argument."
            )
        key = (path, model)
        if key not in _PARAM_CACHE:
            _PARAM_CACHE[key] = load_crepe_params(path, model)
        params = _PARAM_CACHE[key]

    net = build_crepe(params, model, device)
    probs = crepe_probs(net, frame_audio(audio16k, hop_length))
    return viterbi_decode(probs, f0_min, f0_max)


def get_f0_features_using_crepe(
    audio: np.ndarray,
    mel_len: int,
    fs: int,
    hop_length: int,
    hop_length_new: int,
    f0_min: float,
    f0_max: float,
    threshold: float = 0.3,
    model: str = "full",
    params=None,
    device=None,
) -> np.ndarray:
    """The reference chain -> f0 [mel_len] at hop ``hop_length`` of ``fs``;
    the net predicts at hop ``hop_length_new`` of 16 kHz on ``device``."""
    from svc_inference_pipeline_tpu_torch.ops.resample import resample_host

    audio = np.asarray(audio, dtype=np.float32)
    audio16k = resample_host(audio, fs, SAMPLE_RATE) if fs != SAMPLE_RATE else audio

    f0, pd = crepe_predict(audio16k, hop_length_new, f0_min, f0_max, model, params, device)

    pd = median_filter(pd, 3)
    loud = a_weighted_loudness(audio16k, hop_length_new)
    n = min(len(pd), len(loud))
    pd, f0 = pd[:n], np.asarray(f0[:n], dtype=np.float64)
    pd[loud[:n] < -60.0] = 0.0
    f0[pd < threshold] = np.nan
    f0 = mean_filter(f0, 3)
    f0 = np.nan_to_num(f0, nan=0.0)

    nz = np.nonzero(f0)[0]
    if len(nz) == 0:
        return np.zeros(mel_len)
    time_org = hop_length_new / SAMPLE_RATE * nz
    time_frame = np.arange(mel_len) * hop_length / fs
    return np.interp(time_frame, time_org, f0[nz], left=f0[nz][0], right=f0[nz][-1])
