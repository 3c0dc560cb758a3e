"""Adversarial vocoder training (the BigVGAN objective).

Counterpart of ``svc_inference_pipeline_tpu/training/gan.py`` on one device
(its ``mesh=`` branch is not ported):

* LS-GAN adversarial losses over the MPD and the MRD,
* feature matching, the L1 distance of every discriminator feature map,
* the log-mel L1 reconstruction loss weighted by 45,

as two steps, ``(disc_step, gen_step)``. The generator is built with
``use_kernels=False``: the JAX steps build ``BigVGANGenerator`` with
``use_pallas=False``, and the port's kernels write through ctypes, outside
autograd. The generator's output is detached in the discriminator step.
``torch.optim.AdamW(2e-4, betas=(0.8, 0.99), weight_decay=1e-4)`` takes the
place of ``optax.adamw(2e-4, b1=0.8, b2=0.99)``, whose weight decay
defaults to 1e-4 (torch's to 1e-2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
from svc_inference_pipeline_tpu_torch.models.discriminators import (
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
)
from svc_inference_pipeline_tpu_torch.ops.mel import mel_spectrogram
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

MEL_LOSS_WEIGHT = 45.0
FM_WEIGHT = 2.0
LR = 2e-4
BETAS = (0.8, 0.99)
WEIGHT_DECAY = 1e-4  # optax.adamw's default
UP_INIT_STD = 0.01  # JAX's TorchConvTranspose1d kernels: nn.initializers.normal(0.01)


@dataclass
class GANTrainState:
    """``step`` counts generator steps, as the JAX state's does."""

    step: int
    generator: BigVGANGenerator
    mpd: MultiPeriodDiscriminator
    mrd: MultiResolutionDiscriminator
    gen_optimizer: torch.optim.Optimizer
    disc_optimizer: torch.optim.Optimizer


def make_optimizer(params) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=LR, betas=BETAS, eps=1e-8, weight_decay=WEIGHT_DECAY)


def init_gan_train_state(cfg, generator: torch.Generator, gen_optimizer: Optional[Callable] = None,
                         disc_optimizer: Optional[Callable] = None, device=None):
    """(state, generator's optimizer, discriminators' optimizer) at step 0 on
    ``device`` (None: the GPU, see ``resolve_device``): f32 modules of
    ``cfg.vocoder`` drawn from ``generator`` at the scales of JAX's
    ``init`` (``random_init_``, whose N(0, 1/fan_in) is lecun_normal's
    variance, and the up-convs N(0, UP_INIT_STD^2) as JAX draws them), the
    generator on its training route (``use_kernels=False``), and the two
    AdamWs (or what ``gen_optimizer`` and ``disc_optimizer``, functions of a
    parameter list, make).

    The up-convs' scale matters: at N(0, 1/fan_in) the narrow stages keep
    their input's variance where JAX's shrink it, and a full-width
    generator's pre-tanh output grows to hundreds, saturating tanh to
    exactly +-1 over whole MRD frames; such a frame has exactly zero STFT
    bins, whose magnitude (no floor, as in JAX) has a NaN gradient."""
    device = resolve_device(device)
    vcfg = cfg.vocoder
    with torch.device(device):
        gen = BigVGANGenerator(vcfg, use_kernels=False)
        mpd, mrd = MultiPeriodDiscriminator(vcfg), MultiResolutionDiscriminator(vcfg)
    for m in (gen, mpd, mrd):
        random_init_(m, generator)
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, torch.nn.ConvTranspose1d):
                m.weight.normal_(0.0, UP_INIT_STD, generator=generator)
    gopt = (gen_optimizer or make_optimizer)(list(gen.parameters()))
    dopt = (disc_optimizer or make_optimizer)(list(mpd.parameters()) + list(mrd.parameters()))
    return GANTrainState(0, gen, mpd, mrd, gopt, dopt), gopt, dopt


def ls_disc_loss(reals: List[torch.Tensor], fakes: List[torch.Tensor]) -> torch.Tensor:
    """sum over branches of mean((r - 1)^2) + mean(f^2)."""
    loss = 0.0
    for r, f in zip(reals, fakes):
        loss = loss + torch.mean((r - 1.0) ** 2) + torch.mean(f ** 2)
    return loss


def ls_gen_loss(fakes: List[torch.Tensor]) -> torch.Tensor:
    """sum over branches of mean((f - 1)^2)."""
    loss = 0.0
    for f in fakes:
        loss = loss + torch.mean((f - 1.0) ** 2)
    return loss


def feature_matching(fmaps_r, fmaps_g) -> torch.Tensor:
    """sum over branches and layers of mean|r - g|."""
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss


def make_gan_train_steps(cfg, gen_optimizer: torch.optim.Optimizer,
                         disc_optimizer: torch.optim.Optimizer) -> Tuple[Callable, Callable]:
    """``(disc_step, gen_step)`` for the optimizers of a state made by
    :func:`init_gan_train_state`, over a batch ``{"mel": [B, T, n_mels]
    log-mel, "wave": [B, T * hop]}``, moved to the modules' device:
    ``disc_step(state, batch) -> (state, loss)`` and ``gen_step(state,
    batch) -> (state, loss, {"adv", "fm", "mel_l1"})``, each one AdamW step
    of its side under autograd (whatever the caller's grad mode);
    ``gen_step`` advances ``state.step``."""

    def mel_of(wave: torch.Tensor) -> torch.Tensor:
        return mel_spectrogram(wave, cfg.n_fft, cfg.n_mels, cfg.fs, cfg.hop_length, cfg.win_length,
                               cfg.fmin, cfg.fmax)

    def on_device(state: GANTrainState, batch) -> Dict[str, torch.Tensor]:
        if state.gen_optimizer is not gen_optimizer or state.disc_optimizer is not disc_optimizer:
            raise ValueError("the state's optimizers are not the ones these steps were made for")
        device = next(state.generator.parameters()).device
        return {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32) for k in ("mel", "wave")}

    def disc_step(state: GANTrainState, batch):
        batch = on_device(state, batch)
        state.disc_optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            y = batch["wave"]
            with torch.no_grad():
                y_hat = state.generator(batch["mel"])
            mpd_r, mpd_g, _, _ = state.mpd(y, y_hat)
            mrd_r, mrd_g, _, _ = state.mrd(y, y_hat)
            loss = ls_disc_loss(mpd_r, mpd_g) + ls_disc_loss(mrd_r, mrd_g)
            loss.backward()
        state.disc_optimizer.step()
        return state, loss.detach()

    def gen_step(state: GANTrainState, batch):
        batch = on_device(state, batch)
        state.gen_optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            y = batch["wave"]
            y_hat = state.generator(batch["mel"])
            mpd_r, mpd_g, mpd_fr, mpd_fg = state.mpd(y, y_hat)
            mrd_r, mrd_g, mrd_fr, mrd_fg = state.mrd(y, y_hat)
            adv = ls_gen_loss(mpd_g) + ls_gen_loss(mrd_g)
            fm = feature_matching(mpd_fr, mpd_fg) + feature_matching(mrd_fr, mrd_fg)
            mel_l1 = torch.mean(torch.abs(mel_of(y_hat) - mel_of(y)))
            loss = adv + FM_WEIGHT * fm + MEL_LOSS_WEIGHT * mel_l1
            # the generator's parameters only, as JAX differentiates them
            params = list(state.generator.parameters())
            for p, g in zip(params, torch.autograd.grad(loss, params)):
                p.grad = g
        state.gen_optimizer.step()
        state.step += 1
        return state, loss.detach(), {"adv": adv.detach(), "fm": fm.detach(), "mel_l1": mel_l1.detach()}

    return disc_step, gen_step
