"""Streaming conversion of the port (``pipeline/streaming.py``): the chunking,
pinned pitch factor and crossfades against the JAX ``stream_convert`` on one
deterministic stand-in pipeline, then one real stream through a tiny port
pipeline on CPU."""

import jax
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.pipeline.streaming import stream_convert as jax_stream_convert
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.measure import synth_clip
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count
from svc_inference_pipeline_tpu_torch.pipeline.streaming import convert_streaming, stream_convert

SINGER = "svcc_CDF1"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ScalePipe:
    """Pipeline stand-in whose conversion is the input at half scale; it
    records the pitch factor and sampler arguments of every call."""

    device = torch.device("cpu")

    def __init__(self, cfg):
        self.cfg = cfg
        self.calls = []

    def mel_frame_count(self, n_samples):
        return mel_frame_count(self.cfg, n_samples)

    def convert(self, wav, singer, pitch_factor=None, sampler=None, speedup=None, **kw):
        self.calls.append((len(wav), pitch_factor, sampler, speedup))
        return 0.5 * np.asarray(wav, np.float32)


@pytest.fixture(scope="module")
def clip():
    return synth_clip(24000, 7.0)


def test_stream_convert_matches_jax(cfg, clip):
    """Chunk count, every chunk, and the pitch factor pinned from the first
    chunk and passed to every conversion, equal to the JAX stream's."""
    ours, ref = ScalePipe(HParams(**cfg.to_dict())), ScalePipe(cfg)
    kw = dict(chunk_seconds=2.0, context_seconds=0.5, sampler="plms", speedup=10)
    got = list(stream_convert(ours, clip, SINGER, generator=torch.Generator().manual_seed(3), **kw))
    want = list(jax_stream_convert(ref, clip, SINGER, key=jax.random.PRNGKey(3), **kw))
    assert len(got) == len(want) == 4 and len(ours.calls) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert sum(map(len, got)) == len(clip)
    factors = [c[1] for c in ours.calls]
    assert factors[0] is not None and len(set(factors)) == 1
    np.testing.assert_allclose(factors, [c[1] for c in ref.calls], rtol=1e-6)
    assert [c[0] for c in ours.calls] == [c[0] for c in ref.calls] == [72000] * 4
    assert {c[2:] for c in ours.calls} == {("plms", 10)}


def test_short_input_is_one_conversion(cfg):
    pipe = ScalePipe(HParams(**cfg.to_dict()))
    out = convert_streaming(pipe, synth_clip(24000, 2.4), SINGER, chunk_seconds=2.0, context_seconds=0.5)
    assert len(out) == 57600 and pipe.calls == [(57600, None, None, None)]


def test_real_stream_on_a_tiny_pipeline(cfg, clip):
    """Every chunk converts at one padded length; the chunks partition the
    input; the seams are as smooth as the rest (tests/test_streaming.py's
    bound); the chunks' generators follow the call's."""
    d = cfg.to_dict()
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 10], residual_layer_num=2, residual_channels=64,
                       sampler="plms")
    d["vocoder"]["upsample_initial_channel"] = 64
    pipe = SVCPipeline.from_config(HParams(**d), random_weights=True, device="cpu")
    shapes, seeds = set(), []
    extract, convert = pipe.extract_features, pipe.convert

    def spy_extract(*a, **kw):
        batch, n = extract(*a, **kw)
        shapes.add(tuple(batch["melody"].shape))
        return batch, n

    def spy_convert(*a, generator=None, **kw):
        seeds.append(generator.initial_seed())
        return convert(*a, generator=generator, **kw)

    pipe.extract_features, pipe.convert = spy_extract, spy_convert
    chunks = list(pipe.convert_streaming(clip, SINGER, chunk_seconds=2.0, context_seconds=0.5,
                                         generator=torch.Generator().manual_seed(7)))
    assert len(chunks) == 4 and sum(len(c) for c in chunks) == len(clip)
    assert len(shapes) == 1 and len(set(seeds)) == 4
    wave = np.concatenate(chunks)
    assert np.isfinite(wave).all() and np.abs(wave).max() > 1e-4
    d = np.abs(np.diff(wave))
    typical = np.percentile(d, 99.9)
    pos = 0
    for c in chunks[:-1]:
        pos += len(c)
        assert d[pos - 2: pos + 1].max() <= max(5.0 * typical, 1e-3), (pos, typical)
