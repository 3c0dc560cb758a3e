"""The port's multi-device code on the CPU, single-process parts, and the
shared machinery of the multi-rank files (``test_torch_parallel_2ranks.py``,
``test_torch_parallel_4ranks.py``).

Here: ``ensure_initialized``'s environment handling (as
``tests/test_parallel.py``'s), the TP rule tables against JAX's
``param_specs`` name by name through the weights bridge, the vocoder's
receptive radius, ``chunked_vocoder_apply`` without a mesh against JAX's
(the exact path at 2 and 4 chunks and each unchunked return), and the
``SVCPipeline`` checks that need no second rank.

The multi-rank files spawn their ranks once per file (:func:`run_ranks`:
``parallel.distributed.spawn`` over a file store in ``tmp_path``, gloo on
the CPU, a 60 s collective timeout and a join timeout, so a wedged rank
fails its file instead of hanging the suite). Each rank computes every case
of the file with :func:`rank_cases` and returns each case's result, or the
traceback it raised, so every case is its own test. The rank bodies below
import no JAX: the spawned processes are plain PyTorch."""

from __future__ import annotations

import os
import traceback
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu_torch.config import HParams, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (six workers share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# shared machinery of the multi-rank files
# ---------------------------------------------------------------------------


class RankError(str):
    """A case's traceback on a rank, in place of its result."""


def rank_cases(rank: int, world: int, cases: dict) -> dict:
    """Every case of a file on this rank: {name: result or RankError}."""
    out = {}
    for name, (fn, kwargs) in cases.items():
        try:
            out[name] = globals()[fn](rank, world, **kwargs)
        except Exception:  # reported by that case's test
            out[name] = RankError(traceback.format_exc())
    return out


def run_ranks(world: int, cases: dict, tmp_path) -> list:
    """Spawn ``world`` gloo ranks on the CPU that run :func:`rank_cases`;
    their results, rank by rank."""
    from svc_inference_pipeline_tpu_torch.parallel.distributed import spawn

    return spawn(rank_cases, world, args=(cases,), backend="gloo", device="cpu",
                 timeout=COLLECTIVE_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S, workdir=str(tmp_path))


def case_result(results: list, name: str, rank: int = 0):
    """A case's result on ``rank``; fails the test with the rank's traceback."""
    for r, res in enumerate(results):
        if isinstance(res[name], RankError):
            pytest.fail(f"rank {r} of case {name}:\n{res[name]}")
    return results[rank][name]


def small_cfg(mapper=None, vocoder=None, parallel=None, **top) -> HParams:
    """The main config with the repo's artifact paths, f32, mapper and
    vocoder cut to a few layers and narrow widths (overridable)."""
    d = load_config(os.path.join(REPO, "config", "config.json")).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.join(REPO, d[k].lstrip("./"))
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=4, residual_channels=64)
    d["mapper"].update(mapper or {})
    d["vocoder"].update({"upsample_initial_channel": 64, **(vocoder or {})})
    d["parallel"].update(parallel or {})
    d["compute_dtype"] = "float32"
    d.update(top)
    return HParams(**d)


def tone(n: int, f0: float) -> np.ndarray:
    t = np.arange(n) / 24000
    return (0.4 * np.sin(2 * np.pi * f0 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


SINGERS = ["svcc_CDF1", "svcc_CDM1", "svcc_IDF1", "svcc_IDM1"]


def _mesh(world: int, data: int = 1):
    from svc_inference_pipeline_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data=data, model=world // data)


def _np(x):
    return x.detach().float().cpu().numpy()


# --------------------------------------------------------------- rank bodies


def case_tp_encoder(rank, world, cfg, params, batch):
    """The condition encoder sharded by MAPPER_TP_RULES over a model axis of ``world``."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder
    from svc_inference_pipeline_tpu_torch.parallel.mesh import axis_group
    from svc_inference_pipeline_tpu_torch.parallel.sharding import MAPPER_TP_RULES, shard_params

    mesh = _mesh(world)
    enc = shard_params(load_jax_params(ConditionEncoder(cfg), params), mesh, MAPPER_TP_RULES)
    with torch.no_grad():
        out = enc({k: torch.from_numpy(v) for k, v in batch.items()}, axis_group(mesh, "model"))
    return {"cond": _np(out), "table_rows": enc.melody.weight.shape[0]}


def case_tp_denoiser(rank, world, cfg, params, x, cond, t, num_steps):
    """The denoiser sharded by MAPPER_TP_RULES: its forward and the composed
    (hoisted) eps at step t."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser, make_composed_denoise_fn
    from svc_inference_pipeline_tpu_torch.parallel.mesh import axis_group
    from svc_inference_pipeline_tpu_torch.parallel.sharding import MAPPER_TP_RULES, shard_params

    mesh = _mesh(world)
    group = axis_group(mesh, "model")
    den = shard_params(load_jax_params(DiffSVCDenoiser(cfg, torch.float32), params), mesh, MAPPER_TP_RULES)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    with torch.no_grad():
        eps = den(xt, ct, torch.full((x.shape[0], 1), t), group)
        fn = make_composed_denoise_fn(den, ct, num_steps, torch.float32, group)
        composed = fn(xt, None, torch.full((x.shape[0], 1), t))
    return {"eps": _np(eps), "composed": _np(composed),
            "conv_out": den.block(0).dilated_conv.weight.shape[0]}


def case_tp_whisper(rank, world, dims, params, mel):
    """The Whisper encoder sharded by WHISPER_TP_RULES (K4's plain version on
    n_head / world heads)."""
    from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor
    from svc_inference_pipeline_tpu_torch.parallel.sharding import WHISPER_TP_RULES

    w = WhisperPPGExtractor.from_jax_params(dims, params, "cpu", torch.float32)
    w.shard(_mesh(world), WHISPER_TP_RULES)
    return {"feats": _np(w.embed_audio(torch.from_numpy(mel))), "q_rows": w.encoder.block_0.attn.query.weight.shape[0]}


def case_sp_whisper(rank, world, dims, params, mel):
    from svc_inference_pipeline_tpu_torch.pipeline.content import WhisperPPGExtractor
    from svc_inference_pipeline_tpu_torch.parallel.sp_whisper import encode_sequence_parallel

    w = WhisperPPGExtractor.from_jax_params(dims, params, "cpu", torch.float32)
    return _np(encode_sequence_parallel(w.encoder, torch.from_numpy(mel), _mesh(world)))


def case_pp(rank, world, cfg, params, x, cond, t, num_steps, n_micro):
    """``pp_denoise_fn`` over a pipe axis of ``world`` stages."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.parallel.mesh import PIPE_AXIS, mesh_over
    from svc_inference_pipeline_tpu_torch.parallel.pp import pp_denoise_fn

    mesh = mesh_over(range(world), (world,), (PIPE_AXIS,))
    den = load_jax_params(DiffSVCDenoiser(cfg, torch.float32), params)
    out = pp_denoise_fn(den, torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(x), mesh, cfg,
                        num_steps, n_micro=n_micro)
    return _np(out)


def case_chunked_vocoder(rank, world, vcfg, params, mel, n_chunks, halo):
    """``chunked_vocoder_apply`` with the chunks over a model axis of ``world``."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
    from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import chunked_vocoder_apply

    voc = load_jax_params(BigVGANGenerator(vcfg), params)
    with torch.no_grad():
        return _np(chunked_vocoder_apply(voc, torch.from_numpy(mel), n_chunks, halo, 256, _mesh(world), "model"))


def case_dp_convert(rank, world, sampler, speedup, quantize=None):
    """``convert_batch`` of four clips on a data axis of ``world``, and this
    rank's slice converted by a single-device pipeline with this rank's
    generator."""
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    clips = [tone(24000 - 3000 * (i % 2), 180 + 40 * i) for i in range(4)]
    cfg = small_cfg(denoiser_quantize=quantize)
    pipe = SVCPipeline.from_config(cfg, random_weights=True, device="cpu", mesh=_mesh(world, data=world))
    g = torch.Generator().manual_seed(11)
    waves = pipe.convert_batch(clips, SINGERS, generator=g, sampler=sampler, speedup=speedup)
    alone = SVCPipeline.from_config(cfg, random_weights=True, device="cpu")
    mine = np.array_split(np.arange(4), world)[rank]
    ref = alone.convert_batch([clips[i] for i in mine], [SINGERS[i] for i in mine],
                              generator=pipe.rank_generator(g), sampler=sampler, speedup=speedup)
    odd = pipe.convert_batch(clips[:3], SINGERS[:3], generator=g, sampler=sampler, speedup=speedup)
    return {"waves": waves, "mine": mine, "ref": ref, "odd": odd}


def case_pipeline_routes(rank, world):
    """PLMS conversions of one 3 s clip under TP, SP and PP (``world``
    stages) against one device, f32, and the checks that need a mesh."""
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import chunk_starts

    clip = tone(3 * 24000, 210)  # 320 frames: two vocoder chunks of 160 with their 69-frame halos
    out = {}

    def convert(pipe):
        wave = pipe.convert(clip, SINGERS[0], generator=torch.Generator().manual_seed(3), sampler="plms",
                            speedup=2)
        return wave, _np(pipe.last_mel)

    out["single"] = convert(SVCPipeline.from_config(small_cfg(), random_weights=True, device="cpu"))
    tp = SVCPipeline.from_config(small_cfg(), random_weights=True, device="cpu", mesh=_mesh(world))
    out["tp"] = convert(tp)
    out["voc_chunked"] = tp._voc_chunks == world and chunk_starts(320, world, tp._voc_halo) is not None
    out["sp"] = convert(SVCPipeline.from_config(small_cfg(parallel={"sequence_parallel": True}),
                                                random_weights=True, device="cpu", mesh=_mesh(world)))
    out["pp"] = convert(SVCPipeline.from_config(small_cfg(parallel={"pipeline_stages": world}),
                                                random_weights=True, device="cpu"))
    errors = {}
    for name, kw in (("quantize_tp", dict(cfg=small_cfg(denoiser_quantize="int8"), mesh=_mesh(world))),
                     ("quantize_pp", dict(cfg=small_cfg(denoiser_quantize="int8-w1",
                                                        parallel={"pipeline_stages": world}), mesh=None))):
        try:
            SVCPipeline.from_config(kw["cfg"], random_weights=True, device="cpu", mesh=kw["mesh"])
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def case_train_step(rank, world, cfg, data, jax_state, batch, t, noise):
    """One diffusion train step on a (data x model) mesh from a JAX state and
    draws: the loss and the gathered gradients, parameters, EMA and Adam
    moments."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import train_state_from_jax
    from svc_inference_pipeline_tpu_torch.parallel.sharding import MAPPER_TP_RULES, param_specs, unshard, is_gated
    from svc_inference_pipeline_tpu_torch.parallel.mesh import axis_group
    from svc_inference_pipeline_tpu_torch.training.diffusion import (
        gathered_state_dict, init_diffusion_train_state, make_diffusion_train_step)

    mesh = _mesh(world, data=data)
    state, opt = init_diffusion_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    train_state_from_jax(jax_state, state)
    step = make_diffusion_train_step(cfg, opt, mesh=mesh, ema_decay=0.999)
    state = step.shard_state(state)
    state, loss = step(state, batch, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    group = axis_group(mesh, "model")
    grads = {}
    for key, m in state.modules().items():
        specs = param_specs(m, MAPPER_TP_RULES)
        grads[key] = {n: _np(p.grad if specs[n] is None or group is None
                             else unshard(p.grad, specs[n], group, is_gated(m, n)))
                      for n, p in m.named_parameters()}
    ckpt = gathered_state_dict(state, mesh)
    return {"loss": float(loss), "grads": grads,
            "params": {k: {n: _np(v) for n, v in ckpt[k].items()} for k in ("enc", "den")},
            "ema": {k: {n: _np(v) for n, v in tree.items()} for k, tree in ckpt["ema"].items()},
            "local_rows": state.denoiser.block(0).dilated_conv.weight.shape[0]}


def case_gan_steps(rank, world, cfg, data, jax_state, batch):
    """One discriminator step and, from the same JAX state, one generator
    step on a (data x model) mesh: losses, and the gathered gradients,
    parameters and AdamW moments of the side that stepped."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import train_state_from_jax
    from svc_inference_pipeline_tpu_torch.parallel.mesh import axis_group
    from svc_inference_pipeline_tpu_torch.parallel.sharding import unshard
    from svc_inference_pipeline_tpu_torch.training import gan

    mesh = _mesh(world, data=data)
    group = axis_group(mesh, "model")
    out = {}
    for side in ("disc", "gen"):
        state, gopt, dopt = gan.init_gan_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        train_state_from_jax(jax_state, state)
        disc_step, gen_step = gan.make_gan_train_steps(cfg, gopt, dopt, mesh=mesh)
        state = disc_step.shard_state(state)
        if side == "disc":
            state, loss = disc_step(state, batch)
            res = {"loss": float(loss), "aux": {}, "step": state.step}
            for key, m in (("mpd", state.mpd), ("mrd", state.mrd)):
                moments = [dopt.state[p] for p in m.parameters()]
                res[key] = {"grads": {n: _np(p.grad) for n, p in m.named_parameters()},
                            "params": {n: _np(p) for n, p in m.named_parameters()},
                            **{k: {n: _np(s[k]) for (n, _), s in zip(m.named_parameters(), moments)}
                               for k in ("exp_avg", "exp_avg_sq")}}
        else:
            state, loss, aux = gen_step(state, batch)
            specs = gan.generator_specs(state)
            whole = gan.gathered_generator(state, mesh)
            res = {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()}, "step": state.step,
                   "local_rows": state.generator.conv_pre.conv.weight.shape[0],
                   "generator": {"grads": {n: _np(p.grad if specs[n] is None or group is None
                                                  else unshard(p.grad, specs[n], group))
                                           for n, p in state.generator.named_parameters()},
                                 **{k: {n: _np(v) for n, v in tree.items()} for k, tree in whole.items()}}}
        out[side] = res
    return out


def case_gan_uneven(rank, world, cfg):
    """``shard_state`` at a model axis that a stage's width does not divide:
    the ValueError's message."""
    from svc_inference_pipeline_tpu_torch.training import gan

    state, gopt, dopt = gan.init_gan_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    disc_step, _ = gan.make_gan_train_steps(cfg, gopt, dopt, mesh=_mesh(world))
    try:
        disc_step.shard_state(state)
    except ValueError as e:
        return str(e)
    return None


def case_pp_grads(rank, world, cfg, params, x, cond, t, num_steps, n_micro):
    """The gradients of mean(eps^2) through ``pp_denoise_fn`` over a pipe
    axis of ``world`` stages, summed over the pipe group, and the leaves
    this rank's own backward reached."""
    import torch.distributed as dist

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.parallel.mesh import PIPE_AXIS, mesh_over
    from svc_inference_pipeline_tpu_torch.parallel.pp import pp_denoise_fn

    mesh = mesh_over(range(world), (world,), (PIPE_AXIS,))
    den = load_jax_params(DiffSVCDenoiser(cfg, torch.float32), params)
    eps = pp_denoise_fn(den, torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(x), mesh, cfg,
                        num_steps, n_micro=n_micro)
    (eps ** 2).mean().backward()
    names = [n for n, _ in den.named_parameters()]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in den.parameters()]
    own = [n for n, g in zip(names, grads) if bool(g.abs().max() > 0)]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group(PIPE_AXIS))
    return {"grads": {n: v.view(g.shape).numpy() for n, g, v in zip(names, grads, flat.split([g.numel() for g in grads]))},
            "own": own}


def _batches(n, b=4, t=32, content_dim=16):
    rng = np.random.default_rng(0)
    return [{"mel": rng.standard_normal((b, t, 100)).astype(np.float32) * 0.1,
             "content_whisper": rng.standard_normal((b, t, content_dim)).astype(np.float32),
             "melody": np.abs(rng.uniform(0, 500, (b, t))).astype(np.float32),
             "loudness": np.abs(rng.uniform(0, 1, (b, t))).astype(np.float32),
             "singer": rng.integers(0, 8, (b, 1)).astype(np.int32)} for _ in range(n)]


def train_cfg() -> HParams:
    return small_cfg(mapper={"residual_layer_num": 2, "noise_schedule_factors": [0.0001, 0.02, 10],
                             "input_content_dim": {"whisper": 16}, "content_feature": ["whisper"],
                             "residual_channels": 64})


def case_train_resume(rank, world, ckpt_dir):
    """``train_diffusion`` on a data x model mesh: 3 steps with a checkpoint
    (rank 0 writes the gathered state), then rank 0 alone resumes it on one
    device and runs to step 5; also the mesh run to 5 and a single-device
    run to 5 from the start. Returns rank 0's flat states."""
    from svc_inference_pipeline_tpu_torch.training.diffusion import gathered_state_dict
    from svc_inference_pipeline_tpu_torch.training.loop import state_dict_of, train_diffusion

    import torch.distributed as dist

    cfg, batches = train_cfg(), _batches(5)
    mesh = _mesh(world, data=2)
    part = train_diffusion(cfg, batches[:3], num_steps=3, checkpoint_dir=ckpt_dir, checkpoint_every=3, mesh=mesh,
                           seed=4, device="cpu")
    at3 = gathered_state_dict(part, mesh)
    whole_mesh = gathered_state_dict(train_diffusion(cfg, batches, num_steps=5, mesh=mesh, seed=4, device="cpu"),
                                     mesh)
    dist.barrier()
    if rank != 0:
        return None

    def flat(sd):
        return {f"{k}.{n}": _np(v) for k in ("enc", "den") for n, v in sd[k].items()} | {
            f"ema.{k}.{n}": _np(v) for k, tree in sd["ema"].items() for n, v in tree.items()}

    loaded = train_diffusion(cfg, batches, num_steps=3, checkpoint_dir=ckpt_dir, seed=4, device="cpu")
    resumed = train_diffusion(cfg, batches[3:], num_steps=5, checkpoint_dir=ckpt_dir, checkpoint_every=100,
                              seed=4, device="cpu")
    single = train_diffusion(cfg, batches, num_steps=5, seed=4, device="cpu")
    return {"at3": flat(at3), "loaded": flat(state_dict_of(loaded)), "loaded_step": loaded.step,
            "resumed": flat(state_dict_of(resumed)), "whole_mesh": flat(whole_mesh),
            "single": flat(state_dict_of(single)), "resumed_step": resumed.step}


# ------------------------------------------------------- single-process tests


def test_distributed_single_process_noop(monkeypatch):
    from svc_inference_pipeline_tpu_torch.parallel import distributed

    for k in ("SVC_COORDINATOR", "SVC_NUM_PROCESSES", "SVC_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.is_distributed_env()
    assert distributed.ensure_initialized(device="cpu") is False
    info = distributed.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1 and info["global_devices"] == 1


def test_distributed_env_detection(monkeypatch):
    from svc_inference_pipeline_tpu_torch.parallel import distributed

    monkeypatch.delenv("SVC_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("SVC_COORDINATOR", "10.0.0.1:8476")
    assert distributed.is_distributed_env()
    monkeypatch.delenv("SVC_COORDINATOR", raising=False)
    assert not distributed.is_distributed_env()
    monkeypatch.setenv("SVC_NUM_PROCESSES", "4")
    assert distributed.is_distributed_env()


def test_distributed_inconsistent_config_fails_fast(monkeypatch):
    from svc_inference_pipeline_tpu_torch.parallel import distributed

    # coordinator without topology: a clear error, not a hang in the rendezvous
    monkeypatch.setenv("SVC_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.delenv("SVC_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("SVC_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="SVC_NUM_PROCESSES"):
        distributed.ensure_initialized(device="cpu")
    # topology without coordinator: refuse to run N independent copies
    monkeypatch.delenv("SVC_COORDINATOR", raising=False)
    monkeypatch.setenv("SVC_NUM_PROCESSES", "4")
    with pytest.raises(ValueError, match="SVC_COORDINATOR"):
        distributed.ensure_initialized(device="cpu")


@pytest.fixture(scope="module")
def jax_trees():
    return _jax_trees(small_cfg())


def _jax_trees(cfg):
    """JAX parameter trees (numpy) of the mapper, the vocoder and Whisper at
    small sizes, and the port's modules they convert into."""
    import jax
    import jax.numpy as jnp

    from svc_inference_pipeline_tpu.config import HParams as JaxHParams
    from svc_inference_pipeline_tpu.models.bigvgan import BigVGANGenerator as JaxVoc
    from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDen
    from svc_inference_pipeline_tpu.models.encoder import ConditionEncoder as JaxEnc
    from svc_inference_pipeline_tpu.models.whisper import WhisperAudioEncoder as JaxWhisper
    from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxDims
    from svc_inference_pipeline_tpu.utils.devices import fast_random_params
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, unstack_blocks
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder
    from svc_inference_pipeline_tpu_torch.models.whisper import WhisperAudioEncoder, WhisperDims

    jcfg = JaxHParams(**cfg.to_dict())
    key = jax.random.PRNGKey(0)
    m = jcfg.mapper
    dims = (8, 64, 32, 4, 2, 100, 16, 32, 4, 2)
    inits = [
        lambda: JaxEnc(m).init(key, {"content_whisper": jnp.zeros((1, 4, m.input_content_dim["whisper"])),
                                     "melody": jnp.zeros((1, 4)), "loudness": jnp.zeros((1, 4)),
                                     "singer": jnp.zeros((1, 1), jnp.int32)}),
        lambda: JaxDen(m).init(key, jnp.zeros((1, 4, m.n_mel)), jnp.zeros((1, 4, m.conditioner_size)),
                               jnp.zeros((1, 1), jnp.int32)),
        lambda: JaxVoc(jcfg.vocoder).init(key, jnp.zeros((1, 4, 100))),
        lambda: JaxWhisper(JaxDims(*dims)).init(key, jnp.zeros((1, 8, 128))),
    ]
    trees = [jax.device_get(fast_random_params(f, seed=i)["params"]) for i, f in enumerate(inits)]
    port = [load_jax_params(ConditionEncoder(cfg.mapper), trees[0]),
            load_jax_params(DiffSVCDenoiser(cfg.mapper), trees[1]),
            load_jax_params(BigVGANGenerator(cfg.vocoder), trees[2]),
            load_jax_params(WhisperAudioEncoder(WhisperDims(*dims)), unstack_blocks(trees[3], dims[4]))]
    return trees, port


@pytest.mark.parametrize("table", ["MAPPER_TP_RULES", "VOCODER_TP_RULES", "WHISPER_TP_RULES"])
def test_param_specs_match_jax_name_by_name(table, jax_trees):
    """For every parameter of the mapper, vocoder and Whisper, the dim the
    port's rules shard is the JAX spec's sharded axis carried through the
    bridge's layout change, and every rule matches something."""
    import jax

    from svc_inference_pipeline_tpu.parallel import sharding as jsh
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import jax_path_of
    from svc_inference_pipeline_tpu_torch.parallel import sharding

    trees, port = jax_trees
    rules, jrules = getattr(sharding, table), getattr(jsh, table)
    assert [p for p, _ in rules] == [p for p, _ in jrules]
    sharded = 0
    for tree, module in zip(trees, port):
        specs = jax.tree_util.tree_flatten_with_path(jsh.param_specs(tree, jrules),
                                                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        jax_specs = {"/".join(str(getattr(k, "key", k)) for k in kp): tuple(s) for kp, s in specs}
        for name, dim in sharding.param_specs(module, rules).items():
            path, perm = jax_path_of(module, name)
            want = jax_specs[path]
            jax_dim = want.index("model") if "model" in want else None
            assert dim == (None if jax_dim is None else (perm.index(jax_dim) if perm else jax_dim)), (name, want)
            sharded += dim is not None
    assert sharded > 0


def test_vocoder_receptive_radius_matches_jax():
    from svc_inference_pipeline_tpu.config import HParams as JaxHParams
    from svc_inference_pipeline_tpu.parallel.tp_vocoder import vocoder_receptive_radius as jax_radius
    from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import vocoder_receptive_radius

    full = load_config(os.path.join(REPO, "config", "config.json"))
    tiny = small_cfg(vocoder={"resblock": "2", "resblock_dilation_sizes": [[1, 3]] * 3,
                              "upsample_rates": [4, 4, 4, 4], "upsample_kernel_sizes": [8, 8, 8, 8]})
    for cfg in (full, tiny):
        assert vocoder_receptive_radius(cfg.vocoder) == jax_radius(JaxHParams(**cfg.to_dict()).vocoder)


def tiny_vocoder_params(cfg):
    """JAX's tiny BigVGAN (64 channels) and its weights: random 1-D leaves,
    the others scaled 6x as JAX's chunking test does (so a seam error shows)."""
    import jax

    from svc_inference_pipeline_tpu.config import HParams as JaxHParams
    from svc_inference_pipeline_tpu.models.bigvgan import BigVGANGenerator as JaxVoc
    from svc_inference_pipeline_tpu.utils.devices import fast_random_params

    jv = JaxVoc(JaxHParams(**cfg.to_dict()).vocoder)
    params = fast_random_params(lambda: jv.init(jax.random.PRNGKey(0), np.zeros((1, 8, 100), np.float32)),
                                seed=2)["params"]
    rng = np.random.default_rng(7)
    return jv, jax.tree_util.tree_map(
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32) if np.ndim(x) == 1
        else np.asarray(x, np.float32) * 6.0, jax.device_get(params))


@pytest.fixture(scope="module")
def tiny_voc():
    """The tiny BigVGAN in both frameworks, and a mel."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator

    cfg = small_cfg()
    jv, params = tiny_vocoder_params(cfg)
    mel = (0.1 * np.random.default_rng(1).standard_normal((2, 64, 100))).astype(np.float32)
    return cfg, jv, params, load_jax_params(BigVGANGenerator(cfg.vocoder), params), mel


def _local_op(xp, mel):
    """A stand-in generator, local in time: frame t's hop samples are
    mel[t-1] + 2 mel[t] + mel[t+1] summed over mels (zero past the edges),
    ramped over the hop. ``xp`` is numpy or jax.numpy."""
    m = mel.sum(-1)
    zero = m[:, :1] * 0
    y = xp.concatenate([zero, m[:, :-1]], 1) + 2 * m + xp.concatenate([m[:, 1:], zero], 1)
    ramp = xp.arange(256, dtype=mel.dtype) / 256
    return (y[:, :, None] * (1 + ramp)).reshape(y.shape[0], -1)


@pytest.mark.parametrize("n_chunks,t_len,halo", [(2, 64, 8), (4, 64, 8), (4, 48, 20), (4, 62, 4)],
                         ids=["exact-2", "exact-4", "short", "indivisible"])
def test_chunked_vocoder_matches_jax(n_chunks, t_len, halo):
    """Without a mesh the chunks fold into the batch: through a stand-in
    generator local in time, the port's chunked wave equals JAX's chunked
    wave where the split is exact (2 and 4 chunks), and where JAX returns
    the unchunked call (chunks shorter than their halos, T not divisible)
    the port returns it too."""
    import jax.numpy as jnp

    from svc_inference_pipeline_tpu.parallel.tp_vocoder import chunked_vocoder_apply as jax_chunked
    from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import chunk_starts, chunked_vocoder_apply

    mel = np.random.default_rng(n_chunks + t_len).standard_normal((2, t_len, 100)).astype(np.float32)
    calls = {"jax": [], "port": []}

    def jax_fn(m):
        calls["jax"].append(m.shape)
        return _local_op(jnp, m)

    def port_fn(m):
        calls["port"].append(tuple(m.shape))
        return torch.from_numpy(_local_op(np, m.numpy()))

    want = np.asarray(jax_chunked(jax_fn, jnp.asarray(mel), n_chunks, halo, 256))
    got = chunked_vocoder_apply(port_fn, torch.from_numpy(mel), n_chunks, halo, 256).numpy()
    assert calls["port"] == [tuple(s) for s in calls["jax"]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # numpy and XLA sum the mels in other orders
    exact = chunk_starts(t_len, n_chunks, halo) is not None
    assert exact == ((n_chunks, t_len) in ((2, 64), (4, 64)))
    assert calls["port"] == ([(2 * n_chunks, t_len // n_chunks + 2 * halo, 100)] if exact else [(2, t_len, 100)])
    if exact:  # the seams are exact: the chunked wave is the whole call's
        np.testing.assert_allclose(got, _local_op(np, mel), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_tiny_bigvgan_matches_jax(tiny_voc, n_chunks):
    """The tiny BigVGAN chunked on both sides, within 2e-4 of max|wave|."""
    import jax.numpy as jnp

    from svc_inference_pipeline_tpu.parallel.tp_vocoder import chunked_vocoder_apply as jax_chunked
    from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import chunked_vocoder_apply

    cfg, jv, params, port, mel = tiny_voc
    want = np.asarray(jax_chunked(lambda m: jv.apply({"params": params}, m), jnp.asarray(mel), n_chunks, 8, 256))
    with torch.no_grad():
        got = chunked_vocoder_apply(port, torch.from_numpy(mel), n_chunks, 8, 256).numpy()
    assert got.shape == want.shape == (2, 64 * 256)
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


def test_pipeline_checks_raise_jax_errors():
    """The checks that need no second rank, with JAX's messages:
    pipeline_stages not dividing the layers, more stages than ranks, and
    sequence_parallel without a model axis of 2 or more."""
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    with pytest.raises(ValueError, match=r"pipeline_stages=3 must divide residual_layer_num=4"):
        SVCPipeline.from_config(small_cfg(parallel={"pipeline_stages": 3}), random_weights=True, device="cpu")
    with pytest.raises(ValueError, match=r"pipeline_stages=2 needs at least that many devices; found 1"):
        SVCPipeline.from_config(small_cfg(parallel={"pipeline_stages": 2}), random_weights=True, device="cpu")
    with pytest.raises(ValueError, match=r"sequence_parallel needs a mesh with a >1 'model' axis"):
        SVCPipeline.from_config(small_cfg(parallel={"sequence_parallel": True}), random_weights=True, device="cpu")


# ------------------------------------------- inputs and JAX references (parent)


PP_L, PP_C, PP_M, PP_T, PP_STEPS = 8, 64, 16, 32, 50  # tests/test_pipeline_parallel.py's setup
WHISPER_DIMS = (8, 64, 32, 4, 2, 100, 16, 32, 4, 2)  # tests/test_parallel.py's SP dims (ctx 64)


def module_setup():
    """Weights (JAX's init, numpy, 1-D leaves drawn) and inputs of the TP
    module cases (the rank bodies' arguments): the condition encoder and the
    denoiser (4 x 64, content 1024 -> 384; tables 256/256/512) and a ctx-64
    Whisper."""
    import jax

    from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims

    cfg = small_cfg()
    (enc, den, _voc, wsp), _ = _jax_trees(cfg)
    rng = np.random.default_rng(21)

    def draw(tree):
        return jax.tree_util.tree_map(
            lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32) if np.ndim(x) == 1
            else np.asarray(x, np.float32), tree)

    enc, den, wsp = draw(enc), draw(den), draw(wsp)
    b, t = 2, 24
    batch = {"content_whisper": rng.standard_normal((b, t, 1024)).astype(np.float32),
             "melody": rng.uniform(0, 900, (b, t)).astype(np.float32),
             "loudness": rng.uniform(0, 1.5, (b, t)).astype(np.float32),
             "singer": np.array([[3], [300]], np.int32)}
    x = rng.standard_normal((b, t, 100)).astype(np.float32)
    cond = rng.standard_normal((b, t, 384)).astype(np.float32)
    mel = rng.standard_normal((1, 8, 128)).astype(np.float32)
    return {"enc": dict(cfg=cfg.mapper, params=enc, batch=batch),
            "den": dict(cfg=cfg.mapper, params=den, x=x, cond=cond, t=2, num_steps=4),
            "whisper": dict(dims=WhisperDims(*WHISPER_DIMS), params=wsp, mel=mel)}


def module_refs(args) -> dict:
    """JAX's single-device outputs of :func:`module_setup`'s cases."""
    import jax.numpy as jnp

    from svc_inference_pipeline_tpu.config import HParams as JaxHParams
    from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDen
    from svc_inference_pipeline_tpu.models.diffsvc_fast import make_fast_denoise_fn
    from svc_inference_pipeline_tpu.models.encoder import ConditionEncoder as JaxEnc
    from svc_inference_pipeline_tpu.models.whisper import WhisperAudioEncoder as JaxWhisper
    from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxDims

    m = JaxHParams(**args["enc"]["cfg"].to_dict())
    d, w = args["den"], args["whisper"]
    b = d["x"].shape[0]
    step = jnp.full((b, 1), d["t"], jnp.int32)
    return {
        "cond": np.asarray(JaxEnc(m).apply({"params": args["enc"]["params"]},
                                           {k: jnp.asarray(v) for k, v in args["enc"]["batch"].items()})),
        "eps": np.asarray(JaxDen(m, compute_dtype=jnp.float32).apply(
            {"params": d["params"]}, jnp.asarray(d["x"]), jnp.asarray(d["cond"]), step)),
        "composed": np.asarray(make_fast_denoise_fn(d["params"], jnp.asarray(d["cond"]), d["num_steps"], m,
                                                    jnp.float32)(jnp.asarray(d["x"]), None, step)),
        "whisper": np.asarray(JaxWhisper(JaxDims(*WHISPER_DIMS)).apply({"params": w["params"]}, jnp.asarray(w["mel"]))),
    }


def sp_reference(args, n_shards: int) -> np.ndarray:
    """JAX's ``encode_sequence_parallel`` on a model axis of ``n_shards``
    virtual devices."""
    import jax.numpy as jnp

    from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxDims
    from svc_inference_pipeline_tpu.parallel.mesh import make_mesh as jax_mesh
    from svc_inference_pipeline_tpu.parallel.sp_whisper import encode_sequence_parallel as jax_sp

    w = args["whisper"]
    return np.asarray(jax_sp(w["params"], JaxDims(*WHISPER_DIMS), jnp.asarray(w["mel"]),
                             jax_mesh(data=1, model=n_shards), seq_axis="model"))


def pp_setup():
    """``tests/test_pipeline_parallel.py``'s setup (L 8, C 64, M 16, T 32,
    B 4, steps 7, 7, 23, 23) as numpy, for the port's cases."""
    import jax
    import jax.numpy as jnp

    from svc_inference_pipeline_tpu.config import HParams as JaxHParams
    from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDen

    mcfg = JaxHParams(input_content_dim={"whisper": 32}, content_feature=["whisper"], conditioner_size=PP_C,
                      residual_layer_num=PP_L, residual_channels=PP_C, residual_kernel_size=3,
                      dilation_cycle_length=4, n_mel=PP_M, noise_schedule_factors=[1e-4, 0.02, PP_STEPS],
                      diffusion_fc_size=128)
    params = JaxDen(mcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, PP_T, PP_M)), jnp.zeros((1, PP_T, PP_C)),
                               jnp.zeros((1, 1), jnp.int32))["params"]
    rng = np.random.default_rng(1)
    params = jax.device_get(params)
    params["output_projection"]["kernel"] = (
        rng.standard_normal(params["output_projection"]["kernel"].shape) * 0.1).astype(np.float32)
    x = rng.standard_normal((4, PP_T, PP_M)).astype(np.float32)
    cond = (rng.standard_normal((4, PP_T, PP_C)) * 0.3).astype(np.float32)
    t = np.array([7, 7, 23, 23], np.int32)
    return mcfg, dict(cfg=HParams(**mcfg.to_dict()), params=params, x=x, cond=cond, t=t, num_steps=PP_STEPS,
                      n_micro=2)


def pp_reference(mcfg, args, n_stages: int) -> np.ndarray:
    """JAX's ``pp_denoise_fn`` over ``n_stages`` virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from svc_inference_pipeline_tpu.parallel.pp import PIPE_AXIS as JAX_PIPE
    from svc_inference_pipeline_tpu.parallel.pp import pp_denoise_fn as jax_pp

    mesh = Mesh(np.asarray(jax.devices()[:n_stages]), axis_names=(JAX_PIPE,))
    return np.asarray(jax_pp(jax.tree_util.tree_map(jnp.asarray, args["params"]), jnp.asarray(args["cond"]),
                             jnp.asarray(args["t"]), jnp.asarray(args["x"]), mesh, mcfg, PP_STEPS, n_micro=2))


def pp_grad_reference(mcfg, args, n_stages: int) -> dict:
    """The gradients of mean(eps^2), in the port's layout: JAX's ``jax.grad``
    through its ``pp_denoise_fn`` over ``n_stages`` virtual devices (op by
    op, as ``test_pp_gradients_flow`` takes it: jitted on the CPU it lands
    6.7% from the op-by-op gradients), and the port's own autograd through
    the denoiser's forward on one device, microbatch by microbatch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from svc_inference_pipeline_tpu.parallel.pp import PIPE_AXIS as JAX_PIPE
    from svc_inference_pipeline_tpu.parallel.pp import pp_denoise_fn as jax_pp
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import jax_tree_to_torch, load_jax_params
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser

    mesh = Mesh(np.asarray(jax.devices()[:n_stages]), axis_names=(JAX_PIPE,))
    cond, t, x = (jnp.asarray(args[k]) for k in ("cond", "t", "x"))

    def loss(p):
        return jnp.mean(jnp.square(jax_pp(p, cond, t, x, mesh, mcfg, PP_STEPS, n_micro=args["n_micro"])))

    grads = jax.device_get(jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, args["params"])))
    den = load_jax_params(DiffSVCDenoiser(args["cfg"], torch.float32), args["params"])
    xs, cs, ts = (torch.from_numpy(args[k]) for k in ("x", "cond", "t"))
    bm = xs.shape[0] // args["n_micro"]
    eps = torch.cat([den(xs[i:i + bm], cs[i:i + bm], ts[i:i + bm, None]) for i in range(0, xs.shape[0], bm)])
    (eps ** 2).mean().backward()
    return {"jax": {n: v.numpy() for n, v in jax_tree_to_torch(den, grads).items()},
            "single": {n: p.grad.numpy() for n, p in den.named_parameters()}}


PP_GRAD_JAX_RTOL, PP_GRAD_SINGLE_RTOL = 1e-3, 1e-5  # relative L2 per leaf


def check_pp_grads(results: list, ref: dict, world: int) -> None:
    """Every rank's summed gradients against JAX's and the single-device
    ones, each residual leaf finite and non-zero, and each rank's own
    backward reaching exactly its stage's residual layers."""
    per = PP_L // world
    for r in range(world):
        got = case_result(results, "pp_grads", r)
        for name, want in ref["jax"].items():
            g = got["grads"][name]
            for other, tol in ((want, PP_GRAD_JAX_RTOL), (ref["single"][name], PP_GRAD_SINGLE_RTOL)):
                rel = np.linalg.norm(g - other) / max(np.linalg.norm(other), 1e-30)
                assert rel <= tol, (r, name, rel, tol)
            if name.startswith("residual_"):
                assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        mine = {n.split(".")[0] for n in got["own"] if n.startswith("residual_")}
        assert mine == {f"residual_{i}" for i in range(r * per, (r + 1) * per)}, (r, sorted(mine))


GAN_RESBLOCK2 = dict(resblock="2", resblock_dilation_sizes=[[1, 3]])


def gan_setup(vocoder=None) -> dict:
    """``tests/test_torch_gan.py``'s TINY config (its vocoder updated by
    ``vocoder``), JAX's state from its own init and that file's batch; the
    state goes to the ranks in plain containers (they import no JAX, flax
    or optax)."""
    import jax

    from svc_inference_pipeline_tpu.training import gan as jgan
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import _adam_state
    from test_torch_gan import T_FRAMES, TINY

    jcfg = TINY.replace(vocoder=TINY.vocoder.replace(**(vocoder or {})))
    state0 = jax.device_get(jax.jit(lambda k: jgan.init_gan_train_state(jcfg, k)[0])(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"mel": rng.standard_normal((2, T_FRAMES, 20)).astype(np.float32),
             "wave": (0.1 * rng.standard_normal((2, T_FRAMES * jcfg.hop_length))).astype(np.float32)}

    def plain(opt_state):
        adam = _adam_state(opt_state)
        return (SimpleNamespace(count=adam.count, mu=adam.mu, nu=adam.nu),)

    jax_state = SimpleNamespace(step=state0.step, gen_params=state0.gen_params, mpd_params=state0.mpd_params,
                                mrd_params=state0.mrd_params, gen_opt=plain(state0.gen_opt),
                                disc_opt=plain(state0.disc_opt))
    return {"cfg": HParams(**jcfg.to_dict()), "jcfg": jcfg, "state0": state0, "jax_state": jax_state, "batch": batch}


def gan_reference(setup: dict) -> dict:
    """JAX's discriminator and generator steps from :func:`gan_setup`'s
    state (jitted, as ``tests/test_torch_gan.py`` runs them) in the port's
    names and layouts: losses, gradients, parameters and Adam moments after
    each step."""
    import jax
    import jax.numpy as jnp
    import optax

    from svc_inference_pipeline_tpu.training import gan as jgan
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import _adam_state, jax_tree_to_torch
    from svc_inference_pipeline_tpu_torch.training import gan
    from test_torch_gan import _jax_grads

    cfg, jcfg, state0, batch = setup["cfg"], setup["jcfg"], setup["state0"], setup["batch"]
    opt = optax.adamw(2e-4, b1=0.8, b2=0.99)
    disc_step, gen_step = jgan.make_gan_train_steps(jcfg, opt, opt)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()}
    d_new, d_loss = jax.device_get(disc_step(state0, arrays))
    g_new, g_loss, g_aux = jax.device_get(gen_step(state0, arrays))
    port, _, _ = gan.init_gan_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")

    def conv(module, grads, params, adam, key=None):
        mu, nu = (adam.mu, adam.nu) if key is None else (adam.mu[key], adam.nu[key])
        return {k: {n: v.numpy() for n, v in jax_tree_to_torch(module, tree).items()}
                for k, tree in (("grads", grads), ("params", params), ("exp_avg", mu), ("exp_avg_sq", nu))}

    d_grads = _jax_grads(state0, batch, "disc", jcfg)
    d_adam = _adam_state(d_new.disc_opt)
    ref = {"disc": {"loss": float(d_loss), "aux": {}, "step": 0,
                    "mpd": conv(port.mpd, d_grads["mpd"], d_new.mpd_params, d_adam, "mpd"),
                    "mrd": conv(port.mrd, d_grads["mrd"], d_new.mrd_params, d_adam, "mrd")},
           "gen": {"loss": float(g_loss), "aux": {k: float(v) for k, v in g_aux.items()}, "step": 1,
                   "generator": conv(port.generator, _jax_grads(state0, batch, "gen", jcfg), g_new.gen_params,
                                     _adam_state(g_new.gen_opt))}}
    return ref


def check_gan_steps(got: dict, ref: dict) -> None:
    """A mesh's GAN steps against JAX's with ``tests/test_torch_gan.py``'s
    tolerances: losses, gradients per leaf, parameters after AdamW (looser
    where |g_jax| < SMALL_GRAD), and the moments, exp_avg (0.2 g) within
    GRAD_RTOL and exp_avg_sq (0.01 g^2, whose relative error is twice g's)
    within 2 GRAD_RTOL."""
    from test_torch_gan import GRAD_RTOL, LOSS_RTOL, PARAM_ATOL, SMALL_GRAD, SMALL_GRAD_ATOL

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    for side, modules in (("disc", ("mpd", "mrd")), ("gen", ("generator",))):
        g, r = got[side], ref[side]
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=LOSS_RTOL)
        for k, v in r["aux"].items():
            np.testing.assert_allclose(g["aux"][k], v, rtol=LOSS_RTOL)
        assert g["step"] == r["step"]
        for key in modules:
            want, mine = r[key], g[key]
            assert set(mine["params"]) == set(want["params"])
            for name, w in want["grads"].items():
                assert rel(mine["grads"][name], w) <= GRAD_RTOL, (side, key, name, rel(mine["grads"][name], w))
                small = np.abs(w) < SMALL_GRAD
                diff = np.abs(mine["params"][name] - want["params"][name])
                assert diff[~small].max(initial=0.0) <= PARAM_ATOL, (side, key, name, diff[~small].max())
                assert diff[small].max(initial=0.0) <= SMALL_GRAD_ATOL, (side, key, name)
                assert rel(mine["exp_avg"][name], want["exp_avg"][name]) <= GRAD_RTOL, (side, key, name)
                assert rel(mine["exp_avg_sq"][name], want["exp_avg_sq"][name]) <= 2 * GRAD_RTOL, (side, key, name)


TRAIN_B = 4


def train_setup():
    """A JAX diffusion state at step 0 with every leaf drawn (as
    ``tests/test_torch_training.py`` draws it), one batch of 4 and key 1's
    draws (t and noise); ``state0`` is the state in plain containers."""
    import jax

    from svc_inference_pipeline_tpu.config import HParams as JaxHParams
    from svc_inference_pipeline_tpu.sampling.schedule import DiffusionSchedule as JaxSchedule
    from svc_inference_pipeline_tpu.training.diffusion import DiffusionTrainState as JaxState
    from svc_inference_pipeline_tpu.training.diffusion import init_diffusion_train_state as jax_init

    cfg = train_cfg()
    jcfg = JaxHParams(**cfg.to_dict())
    init, opt = jax_init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)

    def leaf(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if np.ndim(x) < 2:
            return (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32)
        if name.endswith("output_projection/kernel") and not np.any(x):
            return (0.02 * rng.standard_normal(np.shape(x))).astype(np.float32)
        return np.asarray(x, np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, jax.device_get({"enc": init.enc_params, "den": init.den_params}))
    state0 = JaxState(step=init.step, enc_params=params["enc"], den_params=params["den"],
                      opt_state=opt.init(params), ema_params=params)
    batch = _batches(1, b=TRAIN_B)[0]
    key = jax.random.PRNGKey(1)
    sched = JaxSchedule.from_config(jcfg.mapper)
    t_key, n_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (TRAIN_B,), 0, sched.num_steps)).astype(np.int64)
    noise = np.array(jax.random.normal(n_key, batch["mel"].shape, dtype=np.float32))
    st = jax.device_get(state0)
    adam = next(p for p in st.opt_state if hasattr(p, "mu"))
    # plain containers: the spawned ranks import no JAX, flax or optax
    plain = SimpleNamespace(step=st.step, enc_params=st.enc_params, den_params=st.den_params,
                            ema_params=st.ema_params,
                            opt_state=(SimpleNamespace(count=adam.count, mu=adam.mu, nu=adam.nu),))
    return {"cfg": cfg, "jcfg": jcfg, "opt": opt, "jax_state0": state0, "state0": plain, "batch": batch,
            "key": key, "sched": sched, "t": t, "noise": noise}


def train_reference(setup) -> dict:
    """JAX's step from :func:`train_setup`'s state, batch and key, op by op:
    loss, gradients and the new state (numpy)."""
    import jax

    from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDen
    from svc_inference_pipeline_tpu.models.encoder import ConditionEncoder as JaxEnc
    from svc_inference_pipeline_tpu.sampling import ddpm as jddpm
    from svc_inference_pipeline_tpu.training.diffusion import make_diffusion_train_step as jax_make_step

    jcfg, key, sched = setup["jcfg"], setup["key"], setup["sched"]
    enc, den = JaxEnc(jcfg.mapper), JaxDen(jcfg.mapper)
    arrays = {k: jax.numpy.asarray(v) for k, v in setup["batch"].items()}
    s0 = setup["jax_state0"]

    def loss_fn(p):
        cond = enc.apply({"params": p["enc"]}, arrays)
        return jddpm.ddpm_training_loss(lambda x, c, tt: den.apply({"params": p["den"]}, x, c, tt),
                                        arrays["mel"], cond, key, sched)[0]

    with jax.disable_jit():
        state1, loss = jax_make_step(jcfg, setup["opt"], ema_decay=0.999)(s0, arrays, key)
        grads = jax.grad(loss_fn)({"enc": s0.enc_params, "den": s0.den_params})
    return {"cfg": setup["cfg"], "loss": float(loss), "grads": jax.device_get(grads),
            "state1": jax.device_get(state1)}


LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4  # tests/test_torch_training.py's
PARAM_ATOL, SMALL_GRAD, SMALL_GRAD_ATOL, EMA_ATOL = 1e-2 * 1e-4, 1e-6, 2e-4, 1e-6


def in_port_layout(ref: dict) -> dict:
    """JAX's step (:func:`train_reference`) in the port's names and layouts."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import jax_tree_to_torch
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser
    from svc_inference_pipeline_tpu_torch.models.encoder import ConditionEncoder

    modules = {"enc": ConditionEncoder(ref["cfg"].mapper), "den": DiffSVCDenoiser(ref["cfg"].mapper)}
    new = {"enc": ref["state1"].enc_params, "den": ref["state1"].den_params}

    def conv(trees):
        return {k: {n: v.numpy() for n, v in jax_tree_to_torch(m, trees[k]).items()} for k, m in modules.items()}

    return {"loss": ref["loss"], "grads": conv(ref["grads"]), "params": conv(new),
            "ema": conv(ref["state1"].ema_params)}


def single_device_step(setup) -> dict:
    """The port's step on one device from :func:`train_setup`'s state and
    draws, in :func:`in_port_layout`'s form."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import train_state_from_jax
    from svc_inference_pipeline_tpu_torch.training.diffusion import (
        init_diffusion_train_state, make_diffusion_train_step)

    state, opt = init_diffusion_train_state(setup["cfg"], torch.Generator().manual_seed(0), device="cpu")
    train_state_from_jax(setup["state0"], state)
    state, loss = make_diffusion_train_step(setup["cfg"], opt, ema_decay=0.999)(
        state, setup["batch"], t=torch.from_numpy(setup["t"]), noise=torch.from_numpy(setup["noise"]))
    mods = state.modules()
    return {"loss": float(loss),
            "grads": {k: {n: _np(p.grad) for n, p in m.named_parameters()} for k, m in mods.items()},
            "params": {k: {n: _np(p) for n, p in m.named_parameters()} for k, m in mods.items()},
            "ema": {k: {n: _np(v) for n, v in tree.items()} for k, tree in state.ema.items()}}


def check_train_step(got: dict, ref: dict) -> None:
    """A mesh step against a reference step from the same state and draws
    (both in the port's layout), with ``tests/test_torch_training.py``'s
    tolerances: loss, gradients per leaf, parameters after AdamW, EMA (at
    step 0's decay 0.1)."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    for key, grads in ref["grads"].items():
        for name, want in grads.items():
            g = got["grads"][key][name]
            rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= GRAD_RTOL, (key, name, rel)
            small = np.abs(want) < SMALL_GRAD
            diff = np.abs(got["params"][key][name] - ref["params"][key][name])
            assert diff[~small].max(initial=0.0) <= PARAM_ATOL, (key, name)
            assert diff[small].max(initial=0.0) <= SMALL_GRAD_ATOL, (key, name)
            ediff = np.abs(got["ema"][key][name] - ref["ema"][key][name])
            assert ediff[~small].max(initial=0.0) <= EMA_ATOL, (key, name)
            assert ediff[small].max(initial=0.0) <= EMA_ATOL + 0.9 * SMALL_GRAD_ATOL, (key, name)


def spawn_in_thread(world: int, cases: dict, tmp_path):
    """Start :func:`run_ranks` on a thread (the parent computes JAX's side
    meanwhile); ``.result()`` waits for it."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run_ranks, world, cases, tmp_path)
    pool.shutdown(wait=False)
    return future
