"""The plain reference's conversion of one device call of the program.

A call converts a batch of clips in one pass: every clip is padded to the
bucket of the longest, the Whisper windows of the batch are encoded
together, and the sampler's noise is drawn for the whole batch from the
generator the call was given. :meth:`Reference.convert_call` replays such a
call for the rows it is asked about: it works out the batch's padded length
and windows from all the members' audio, draws the same noise from a
generator seeded as the program's was, and converts those rows. A single
clip's conversion is the batch of one.

It imports nothing of the program and takes nothing the program made: the
weights are the checkpoint-layout tensors drawn from the seed, and the
features, kernel-form weights and schedule are worked out here again.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import dsp, nets

INIT_NOISE_STD = 1.0 / 1.2
BUCKET = 64  # frame-count padding of the program's batches
LANE = 128  # width of the fused DDPM path's noise buffer (its draws fill the first n_mel lanes)


def _windows(n_samples: int) -> int:
    len16 = -((-n_samples * 2) // 3)
    return max(1, -(-len16 // dsp.WINDOW_SAMPLES))


def mel_frames(n_samples: int, cfg: dict) -> int:
    """Mel frames of a clip, capped at what its 30 s Whisper windows cover."""
    hop, n_fft = int(cfg["hop_length"]), int(cfg["n_fft"])
    frames = 1 + (n_samples + 2 * ((n_fft - hop) // 2) - n_fft) // hop
    return min(frames, _windows(n_samples) * dsp.WINDOW_FRAMES * dsp.REMAP_SRC // dsp.REMAP_TGT)


class Schedule:
    """Linear DDPM schedule, computed in float64 and kept as float32."""

    def __init__(self, start: float, end: float, steps: int):
        betas = np.linspace(start, end, int(steps))
        alphas = 1.0 - betas
        a_cum = np.cumprod(alphas)
        a_prev = np.append(1.0, a_cum[:-1])
        f32 = np.float32
        self.steps = int(steps)
        self.a_cum = a_cum.astype(f32)
        self.c0 = np.sqrt(1.0 / a_cum).astype(f32)
        self.c1 = np.sqrt(1.0 / a_cum - 1.0).astype(f32)
        self.c2 = (betas * np.sqrt(a_prev) / (1.0 - a_cum)).astype(f32)
        self.c3 = ((1.0 - a_prev) * np.sqrt(alphas) / (1.0 - a_cum)).astype(f32)
        post_var = betas * (1.0 - a_prev) / (1.0 - a_cum)
        self.log_var = np.log(np.maximum(post_var, 1e-20)).astype(f32)


class Reference:
    """The reference system on ``device`` at ``precision`` ("f32" or "fp8")."""

    def __init__(self, cfg: dict, weights: Dict[str, dict], device, precision: str = "f32"):
        self.cfg, self.device = cfg, torch.device(device)
        self.p = nets.Precision(precision)
        self.sd = {name: {k: v.to(self.device, torch.float32) for k, v in part.items()}
                   for name, part in weights.items()}
        self.mcfg, self.vcfg = cfg["mapper"], cfg["vocoder"]
        self.schedule = Schedule(*self.mcfg["noise_schedule_factors"])
        with np.load(cfg["min_mel_file"]) as f:
            self.mel_min = torch.tensor(f["mel_min"].astype(np.float32), device=self.device)
        with np.load(cfg["max_mel_file"]) as f:
            self.mel_max = torch.tensor(f["mel_max"].astype(np.float32), device=self.device)
        with np.load(cfg["target_f0_file"]) as f:
            self.target_median = float(f["voiced_median"])
        with open(cfg["singer_file"]) as f:
            self.singers = json.load(f)

    # -- features ----------------------------------------------------------

    def _features(self, clip: np.ndarray, block_len: int, padded: int, n_windows: int):
        """(content [padded, D], f0 [padded], energy [padded]) of one clip in
        a batch whose audio block is ``block_len`` samples long; frames past
        the clip's own are 0."""
        dev, cfg = self.device, self.cfg
        n = mel_frames(len(clip), cfg)
        f0 = np.zeros(padded, np.float32)
        f0[:n] = dsp.shift_to_target(dsp.f0_on_mel_grid(clip, n, cfg), self.target_median)[:n]
        row = torch.zeros(block_len, dtype=torch.float32, device=dev)
        row[: len(clip)] = torch.as_tensor(clip, device=dev)
        energy = dsp.mel_energy(row, cfg)[:padded]
        energy = F.pad(energy, (0, padded - energy.shape[0]))
        audio16 = dsp.resample_24k_to_16k(row)
        audio16 = F.pad(audio16, (0, n_windows * dsp.WINDOW_SAMPLES - audio16.shape[0]))
        n_head = int(self.cfg["whisper_dims"]["n_audio_head"])
        feats = torch.cat([nets.whisper_encode(self.sd["whisper"], dsp.whisper_log_mel(w), n_head, self.p)
                           for w in audio16.reshape(n_windows, dsp.WINDOW_SAMPLES)])
        content = dsp.remap_hops(feats, padded)
        keep = (torch.arange(padded, device=dev) < n).float()
        return content * keep[:, None], torch.as_tensor(f0, device=dev), energy * keep

    # -- samplers ------------------------------------------------------------

    def _ddpm(self, dens: List[nets.Denoiser], rows: Sequence[int], shape, g) -> List[torch.Tensor]:
        s = self.schedule
        b, t_len, m = shape
        x_all = INIT_NOISE_STD * torch.randn(shape, generator=g, device=self.device)
        xs = [x_all[r].T.contiguous() for r in rows]
        z = torch.zeros((b, t_len, LANE), device=self.device)
        for i in range(s.steps):
            t = s.steps - 1 - i
            z[..., :m].normal_(generator=g)
            sigma = float(np.exp(0.5 * s.log_var[t])) if t > 0 else 0.0
            for k, (den, r) in enumerate(zip(dens, rows)):
                x = xs[k]
                x0 = torch.clamp(float(s.c0[t]) * x - float(s.c1[t]) * den(x, t), -1.0, 1.0)
                xs[k] = float(s.c2[t]) * x0 + float(s.c3[t]) * x + sigma * z[r, :, :m].T
        return xs

    def _plms(self, dens: List[nets.Denoiser], rows: Sequence[int], shape, g, speedup: int) -> List[torch.Tensor]:
        s = self.schedule
        x_all = INIT_NOISE_STD * torch.randn(shape, generator=g, device=self.device)

        def transfer(x, eps, t, t_prev):
            a_t, a_p = s.a_cum[t], s.a_cum[t_prev]
            sq_t, sq_p = np.sqrt(a_t), np.sqrt(a_p)
            d_x = sq_t * (sq_t + sq_p)
            d_eps = sq_t * (np.sqrt((np.float32(1.0) - a_p) * a_t) + np.sqrt((np.float32(1.0) - a_t) * a_p))
            return x + float(a_p - a_t) * (x / float(d_x) - eps / float(d_eps))

        out = []
        for den, r in zip(dens, rows):
            x, hist = x_all[r].T.contiguous(), []
            for t in range(s.steps - 1 - (s.steps - 1) % speedup, -1, -speedup):
                t_prev = max(t - speedup, 0)
                eps = den(x, t)
                if not hist:
                    e = (eps + den(transfer(x, eps, t, t_prev), t_prev)) / 2.0
                elif len(hist) == 1:
                    e = (3.0 * eps - hist[0]) / 2.0
                elif len(hist) == 2:
                    e = (23.0 * eps - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
                else:
                    e = (55.0 * eps - 59.0 * hist[0] + 37.0 * hist[1] - 9.0 * hist[2]) / 24.0
                x = transfer(x, e, t, t_prev)
                hist = [eps] + hist[:2]
            out.append(x)
        return out

    # -- a call --------------------------------------------------------------

    @torch.no_grad()
    def convert_call(self, clips: Sequence[np.ndarray], singers: Sequence[str], gseed: int, sampler: str,
                     speedup: int, rows: Sequence[int]) -> List[Dict[str, np.ndarray]]:
        """For each of ``rows`` of the batch ``clips``: ``mel`` [n, M] (the
        denormalised mel over the clip's frames) and ``wave`` (float32, the
        clip's n * hop samples after the fade-out)."""
        cfg, dev, hop = self.cfg, self.device, int(self.cfg["hop_length"])
        frames = [mel_frames(len(c), cfg) for c in clips]
        padded = -(-max(frames) // BUCKET) * BUCKET
        n_windows = max(max(_windows(len(c)) for c in clips), -(-(padded * 8 // 15 + 1) // dsp.WINDOW_FRAMES))
        block_len = max(len(c) for c in clips)
        dens = []
        for r in rows:
            content, f0, energy = self._features(clips[r], block_len, padded, n_windows)
            cond = nets.condition(self.sd["mapper"], content, f0, energy, int(self.singers[singers[r]]),
                                  self.mcfg, self.p)
            dens.append(nets.Denoiser(self.sd["mapper"], cond, self.mcfg, self.p))
        g = torch.Generator(device=dev).manual_seed(int(gseed))
        shape = (len(clips), padded, int(self.mcfg["n_mel"]))
        if sampler == "ddpm":
            xs = self._ddpm(dens, rows, shape, g)
        elif sampler == "plms":
            xs = self._plms(dens, rows, shape, g, int(speedup))
        else:
            raise ValueError(f"sampler {sampler!r} is not in the reference")
        out = []
        for x, r in zip(xs, rows):
            lo, hi = self.mel_min[:, None], self.mel_max[:, None]
            mel = (x + 1.0) / 2.0 * (hi - lo + 1e-12) + lo  # [M, padded]
            out.append({"mel": mel[:, : frames[r]].T.cpu().numpy(), "wave": self._vocode(mel, frames[r])})
        return out

    def _vocode(self, mel: torch.Tensor, n: int) -> np.ndarray:
        """BigVGAN on a mel [M, T], the fade-out ending at frame n, cut there."""
        hop = int(self.cfg["hop_length"])
        wave = nets.vocode(self.sd["vocoder"], mel, self.vcfg, self.p)[: mel.shape[1] * hop]
        n_end, fade = n * hop, 20 * hop
        idx = torch.arange(wave.shape[0], device=self.device)
        factor = torch.clamp(1.0 - (idx - (n_end - fade)).float() / (fade - 1), 0.0, 1.0)
        wave = wave * torch.where(idx >= n_end, torch.zeros_like(factor), factor)
        return wave[:n_end].cpu().numpy()

    @torch.no_grad()
    def vocode_clip(self, mel: np.ndarray, n: int) -> np.ndarray:
        """The stage after the sampler on a given denormalised mel [T, M]
        (a batch row, padded frames included, as the vocoder saw it):
        BigVGAN, and the fade-out ending at the clip's frame n."""
        return self._vocode(torch.as_tensor(mel, device=self.device).T.float(), n)
