"""Each configuration runs the published widths: Whisper-medium (not the
pipeline builder's "tiny" default) at d = 1024, DiffSVC 20 x 384 over 1000
steps, BigVGAN 1536 with resblock "1"; nothing is listed as reduced."""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, weights  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def configs():
    return [(c, json.loads((ROOT / c["file"]).read_text())) for c in BENCH["configs"]]


def test_published_widths():
    for entry, cfg in configs():
        assert entry["reduced"] == []
        assert cfg["whisper_model"] == "medium"
        assert cfg["whisper_dims"] == {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 1024,
                                       "n_audio_head": 16, "n_audio_layer": 24}
        m, v = cfg["mapper"], cfg["vocoder"]
        assert (m["residual_layer_num"], m["residual_channels"], m["noise_schedule_factors"]) == (
            20, 384, [0.0001, 0.02, 1000])
        assert (v["upsample_initial_channel"], v["resblock"], v["upsample_rates"]) == (1536, "1", [4, 4, 2, 2, 2, 2])
        assert cfg["compute_dtype"] == "bfloat16"
    samplers = {c["name"]: (cfg["mapper"]["sampler"], cfg["mapper"]["plms_speedup"]) for c, cfg in configs()}
    assert samplers == {"svc-ddpm1000-bf16": ("ddpm", 10)}


def test_pipeline_gets_whisper_medium(monkeypatch):
    """The harness builds the program from the configuration's Whisper
    dims through the checkpoint converters: 24 blocks at d = 1024."""
    from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

    def shapes_only(cfg, seed, device):  # zero-strided tensors of the right shapes: no memory
        parts = {"mapper": weights.mapper_leaves(cfg["mapper"], cfg["whisper_dims"]["n_audio_state"]),
                 "vocoder": weights.vocoder_leaves(cfg["vocoder"]),
                 "whisper": weights.whisper_leaves(cfg["whisper_dims"])}
        return {k: {key: torch.zeros(1).expand(shape) for key, shape, _ in leaves} for k, leaves in parts.items()}

    seen = {}

    def capture(cls, cfg, cond, den, voc, dims, wtree, device=None, **kw):
        seen.update(dims=dims, conv1=np.shape(wtree["conv1"]["kernel"]), blocks=sum(k.startswith("block_") for k in wtree),
                    content=np.shape(cond["content_whisper"]["kernel"]))
        return "pipeline"

    monkeypatch.setattr(weights, "make_weights", shapes_only)
    monkeypatch.setattr(SVCPipeline, "from_jax_params", classmethod(capture))
    for _, cfg in configs():
        assert harness.build_pipeline(cfg, 1, "cpu", {}) == "pipeline"
        assert seen["dims"].n_audio_state == 1024 and seen["dims"].n_audio_layer == 24
        assert seen["dims"].n_audio_head == 16 and seen["blocks"] == 24
        assert seen["conv1"] == (3, 80, 1024) and seen["content"] == (1024, 384)
