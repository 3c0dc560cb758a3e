"""Adversarial vocoder training (the BigVGAN objective).

Counterpart of ``svc_inference_pipeline_tpu/training/gan.py``, with its
``mesh=`` branch (data parallelism and the generator's channel TP):

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

On a mesh (one rank a device) the collectives JAX's GSPMD inserts are
written out: the generator runs sharded by ``VOCODER_TP_RULES`` over the
model axis (``BigVGANGenerator(tp_group=)``), the discriminators run
replicated on the whole ``y_hat``, each data rank takes its slice of the
batch, and the losses and every gradient are averaged over the data group.
The discriminators' gradients need no model-axis sum: every model rank
computes them from the same replicated ``y_hat``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_
from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
from svc_inference_pipeline_tpu_torch.models.discriminators import (
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
)
from svc_inference_pipeline_tpu_torch.ops.mel import mel_spectrogram
from svc_inference_pipeline_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size
from svc_inference_pipeline_tpu_torch.parallel.sharding import (
    VOCODER_TP_RULES, batch_shard, param_specs, shard_slice, unshard)
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


def make_gan_train_steps(cfg, gen_optimizer: torch.optim.Optimizer, disc_optimizer: torch.optim.Optimizer,
                         mesh=None) -> Tuple[Callable, Callable]:
    """``(disc_step, gen_step)`` for the optimizers of a state made by
    :func:`init_gan_train_state`, over a batch ``{"mel": [B, T, n_mels]
    log-mel, "wave": [B, T * hop]}``, moved to the modules' device:
    ``disc_step(state, batch) -> (state, loss)`` and ``gen_step(state,
    batch) -> (state, loss, {"adv", "fm", "mel_l1"})``, each one AdamW step
    of its side under autograd (whatever the caller's grad mode);
    ``gen_step`` advances ``state.step``.

    With ``mesh`` (JAX's mesh branch): every rank takes the global batch
    and keeps its data rank's slice (B must divide by the data axis); the
    state must first go through ``step.shard_state`` (either step's: it
    keeps this rank's model-axis slice of the generator's parameters and
    of their AdamW moments); the returned losses and every gradient are
    the data group's means. ``step.batch_shard`` slices a batch by data
    rank. A step on a mesh equals the single-device step up to the order
    of f32 sums."""
    data_group = axis_group(mesh, DATA_AXIS)
    tp_group = axis_group(mesh, MODEL_AXIS)
    n_data = axis_size(mesh, DATA_AXIS)

    def mel_of(wave: torch.Tensor) -> torch.Tensor:
        return mel_spectrogram(wave, cfg.n_fft, cfg.n_mels, cfg.fs, cfg.hop_length, cfg.win_length,
                               cfg.fmin, cfg.fmax)

    def shard(x: torch.Tensor) -> torch.Tensor:
        if mesh is None:
            return x
        if x.shape[0] % n_data:
            raise ValueError(f"a batch of {x.shape[0]} does not divide by the data axis ({n_data})")
        return batch_shard(x, mesh, DATA_AXIS)

    def on_device(state: GANTrainState, batch) -> Dict[str, torch.Tensor]:
        if state.gen_optimizer is not gen_optimizer or state.disc_optimizer is not disc_optimizer:
            raise ValueError("the state's optimizers are not the ones these steps were made for")
        device = next(state.generator.parameters()).device
        return {k: shard(torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32)) for k in ("mel", "wave")}

    def data_mean(losses: List[torch.Tensor], params) -> List[torch.Tensor]:
        """The losses and the parameters' gradients averaged over the data
        group, each in one all-reduce."""
        losses = [x.detach() for x in losses]
        if data_group is None:
            return losses
        grads = [p.grad for p in params if p.grad is not None]
        for tensors in (losses, grads):
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat, group=data_group)
            flat /= n_data
            for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(v.view_as(t))
        return losses

    def disc_step(state: GANTrainState, batch):
        batch = on_device(state, batch)
        state.disc_optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            y = batch["wave"]
            with torch.no_grad():
                y_hat = state.generator(batch["mel"], tp_group)
            mpd_r, mpd_g, _, _ = state.mpd(y, y_hat)
            mrd_r, mrd_g, _, _ = state.mrd(y, y_hat)
            loss = ls_disc_loss(mpd_r, mpd_g) + ls_disc_loss(mrd_r, mrd_g)
            loss.backward()
        loss, = data_mean([loss], list(state.mpd.parameters()) + list(state.mrd.parameters()))
        state.disc_optimizer.step()
        return state, loss

    def gen_step(state: GANTrainState, batch):
        batch = on_device(state, batch)
        state.gen_optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            y = batch["wave"]
            y_hat = state.generator(batch["mel"], tp_group)
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
        loss, adv, fm, mel_l1 = data_mean([loss, adv, fm, mel_l1], params)
        state.gen_optimizer.step()
        state.step += 1
        return state, loss, {"adv": adv, "fm": fm, "mel_l1": mel_l1}

    if mesh is not None:
        for step in (disc_step, gen_step):
            step.shard_state = lambda state: shard_state(state, mesh)
            step.batch_shard = lambda batch: {k: shard(torch.as_tensor(v)) for k, v in batch.items()}
    return disc_step, gen_step


def generator_specs(state: GANTrainState) -> Dict[str, Optional[int]]:
    """{generator parameter name: the dim VOCODER_TP_RULES shards, or None}."""
    return param_specs(state.generator, VOCODER_TP_RULES)


@torch.no_grad()
def shard_state(state: GANTrainState, mesh) -> GANTrainState:
    """Keep this rank's model-axis slice of every generator parameter the
    rules shard, and of its AdamW moments (a state whole on every rank), in
    place; the discriminators and their optimizer stay whole. A width that
    does not divide by the model axis raises ``ValueError`` naming the
    parameter (JAX's GSPMD would pad the shard; here shards are equal)."""
    size, rank = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    if size == 1:
        return state
    specs = generator_specs(state)
    params = dict(state.generator.named_parameters())
    uneven = [f"{n} ({params[n].shape[d]} on dim {d})" for n, d in specs.items()
              if d is not None and params[n].shape[d] % size]
    if uneven:
        raise ValueError(f"the model axis ({size}) does not divide the generator's {', '.join(uneven)}")
    for name, dim in specs.items():
        if dim is None:
            continue
        p = params[name]
        p.data = shard_slice(p.data, dim, rank, size)
        moments = state.gen_optimizer.state.get(p, {})
        for k, v in moments.items():
            if torch.is_tensor(v) and v.dim() > 0:
                moments[k] = shard_slice(v, dim, rank, size)
    return state


@torch.no_grad()
def gathered_generator(state: GANTrainState, mesh) -> Dict[str, Dict[str, torch.Tensor]]:
    """The generator's parameters and AdamW moments whole, the model-axis
    shards all-gathered (every rank of the group must call it):
    ``{"params": {name: tensor}, "exp_avg": {...}, "exp_avg_sq": {...}}``
    (the moments of the parameters that have them)."""
    group = axis_group(mesh, MODEL_AXIS)
    specs = generator_specs(state)

    def whole(name, v):
        return v if specs[name] is None or group is None else unshard(v, specs[name], group)

    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in state.generator.named_parameters():
        out["params"][name] = whole(name, p.detach())
        for k in ("exp_avg", "exp_avg_sq"):
            v = state.gen_optimizer.state.get(p, {}).get(k)
            if v is not None:
                out[k][name] = whole(name, v)
    return out
