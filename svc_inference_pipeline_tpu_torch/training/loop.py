"""Training orchestration: checkpoint and resume, the non-finite-loss guard,
fault hooks and logging.

Counterpart of ``svc_inference_pipeline_tpu/training/loop.py`` (its
``mesh=`` too, see :func:`train_diffusion`):

* a periodic checkpoint of the whole train state to ``<dir>/latest`` (one
  ``torch.save`` of a nested dict: step, enc, den, the optimizer's
  ``state_dict``, ema), written to a temporary file and renamed, so a
  worker that dies while writing leaves the previous one;
* deterministic resume: step k's draws come from a generator seeded from
  (seed, k), so a resumed run draws what an unbroken run draws;
* a step with a non-finite loss is skipped (the train step applies nothing
  then) and counted; more than ``max_bad_steps`` in a row abort the run;
* ``training/elastic.py``'s fault hook and heartbeat every step, and
  ``utils.observability``'s metrics and logger: ``train/loss`` and
  ``train/step_s`` (the wall seconds of each applied step, to its loss on
  the host) are observed, ``train/skipped_nonfinite`` counted.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from svc_inference_pipeline_tpu_torch.checkpoints.native_io import load_checkpoint, save_checkpoint
from svc_inference_pipeline_tpu_torch.training.diffusion import (
    DiffusionTrainState,
    ema_of,
    gathered_state_dict,
    init_diffusion_train_state,
    make_diffusion_train_step,
)
from svc_inference_pipeline_tpu_torch.training.elastic import fault_hook, heartbeat
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device
from svc_inference_pipeline_tpu_torch.utils.observability import Metrics, get_logger


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s draws: seeded from (seed, step) alone
    (JAX's ``fold_in(key, step)``)."""
    s = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def state_dict_of(state: DiffusionTrainState) -> dict:
    """The checkpoint's nested dict."""
    return {"step": state.step, "enc": state.encoder.state_dict(), "den": state.denoiser.state_dict(),
            "optimizer": state.optimizer.state_dict(), "ema": state.ema}


def restore(state: DiffusionTrainState, ckpt: dict) -> DiffusionTrainState:
    """Load a checkpoint into ``state`` in place. A checkpoint without
    ``ema`` (written before the EMA existed) seeds it from the restored
    parameters."""
    state.encoder.load_state_dict(ckpt["enc"])
    state.denoiser.load_state_dict(ckpt["den"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    if ckpt.get("ema") is None:
        state.ema = ema_of(state.modules())
        get_logger("svc_tpu.train").info("migrated pre-EMA checkpoint: EMA seeded from params")
    else:
        device = next(state.denoiser.parameters()).device
        state.ema = {k: {n: v.to(device) for n, v in tree.items()} for k, tree in ckpt["ema"].items()}
    return state


def train_diffusion(cfg, loader: Iterable, num_steps: int, checkpoint_dir: Optional[str] = None,
                    checkpoint_every: int = 1000, mesh=None, seed: int = 0, max_bad_steps: int = 25,
                    device=None) -> DiffusionTrainState:
    """Run the diffusion objective over ``loader`` (restarted when it ends)
    up to ``num_steps`` applied steps on ``device`` (None: the GPU, see
    ``resolve_device``), resuming from ``<checkpoint_dir>/latest`` when it
    exists. A resumed run reads the loader from its start, as the JAX loop
    does.

    With ``mesh`` (data and model axes, one rank a device, every rank
    reading the same loader): the state is sharded after the resume
    (``make_diffusion_train_step``'s mesh branch), and a checkpoint gathers
    the shards and rank 0 writes the single-device layout, so a run resumes
    on any mesh shape, or on one device."""
    log = get_logger("svc_tpu.train")
    metrics = Metrics.default()
    device = resolve_device(device)

    state, optimizer = init_diffusion_train_state(cfg, torch.Generator(device=device).manual_seed(seed),
                                                  device=device)
    step_fn = make_diffusion_train_step(cfg, optimizer, mesh=mesh)
    path = os.path.join(checkpoint_dir, "latest") if checkpoint_dir else None
    start_step = 0
    if path and os.path.exists(path):
        restore(state, load_checkpoint(path))
        start_step = state.step
        log.info("resumed from step %d", start_step)
    if mesh is not None:
        state = step_fn.shard_state(state)

    bad_streak = 0
    it = iter(loader)
    for step in range(start_step, num_steps):
        # env-driven fault injection (SVC_FAULT_INJECT) and the supervisor's
        # heartbeat (SVC_HEARTBEAT_DIR), both no-ops unless set
        injected = fault_hook(step)
        heartbeat(step)
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        if injected == "nan":
            batch = dict(batch, mel=torch.full_like(torch.as_tensor(batch["mel"]), float("nan")))

        t0 = time.perf_counter()
        state, loss = step_fn(state, batch, step_generator(seed, step, device))
        loss_val = float(loss)
        seconds = time.perf_counter() - t0
        if not np.isfinite(loss_val):
            bad_streak += 1
            metrics.incr("train/skipped_nonfinite")
            log.warning("non-finite loss at step %d — skipping update (%d in a row)", step, bad_streak)
            if bad_streak > max_bad_steps:
                raise RuntimeError(f"{bad_streak} consecutive non-finite losses — aborting")
            continue

        bad_streak = 0
        metrics.observe("train/loss", loss_val)
        metrics.observe("train/step_s", seconds)
        if step % 100 == 0:
            log.info("step %d loss %.4f", step, loss_val)
        if path and (step + 1) % checkpoint_every == 0:
            ckpt = state_dict_of(state) if mesh is None else gathered_state_dict(state, mesh)
            if not dist.is_initialized() or dist.get_rank() == 0:
                save_checkpoint(path + ".tmp", ckpt)
                os.replace(path + ".tmp", path)
                log.info("checkpointed step %d → %s", step + 1, path)
            if mesh is not None:
                dist.barrier()  # the file is whole before any rank reads it
    return state
