"""The port's observability (``utils/observability.py``) against the JAX
package's (``capture_intermediates`` on the same bridged denoiser), and the
CLI's batch, bucket, PCM16 and profile options on CPU."""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.utils import observability as jax_obs
from svc_inference_pipeline_tpu_torch import cli
from svc_inference_pipeline_tpu_torch.config import load_config
from svc_inference_pipeline_tpu_torch.measure import synth_clip
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline, mel_frame_count
from svc_inference_pipeline_tpu_torch.utils import audio_io, observability

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "config.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_metrics_match_jax():
    ours, ref = observability.Metrics(), jax_obs.Metrics()
    for m in (ours, ref):
        m.incr("conversions")
        m.incr("conversions", 2.5)
        m.incr("sheds", 0)
        for v in (0.25, 3, 1e-3):
            m.observe("span/convert", v)
        m.observe("latency", 7)
        m.observations["empty"]  # an observed name with no values is left out
    assert ours.summary() == ref.summary() and ours.to_json() == ref.to_json()
    ours.reset()
    assert ours.summary() == {} and ours.to_json() == "{}"


def test_logger_and_trace():
    log = observability.get_logger("svc_tpu.test_port")
    assert log.name == "svc_tpu.test_port" and not log.propagate and log.level == logging.INFO
    assert log.handlers[0].formatter._fmt == jax_obs.get_logger("svc_tpu.test_jax").handlers[0].formatter._fmt
    assert observability.get_logger("svc_tpu.test_port") is log and len(log.handlers) == 1
    metrics = observability.Metrics.default()
    before = len(metrics.observations["span/port-test"])
    with observability.trace("port-test"):
        torch.ones(3).sum()
    assert len(metrics.observations["span/port-test"]) == before + 1


def test_profile_writes_a_chrome_trace(tmp_path):
    with observability.profile(str(tmp_path / "prof")):
        with observability.trace("profiled-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    with open(path) as f:
        trace = json.load(f)
    assert any(ev.get("name") == "profiled-span" for ev in trace["traceEvents"])


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    d = load_config(CONFIG).to_dict()
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.join(REPO, d[k].lstrip("./"))
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, 4], residual_layer_num=2, residual_channels=64)
    d["vocoder"]["upsample_initial_channel"] = 64
    path = tmp_path_factory.mktemp("cfg") / "cfg.json"
    path.write_text(json.dumps(d))
    return str(path)


def _inputs(tmp_path, seconds):
    paths = []
    for i, s in enumerate(seconds):
        paths.append(str(tmp_path / f"in{i}.wav"))
        audio_io.write_wav(paths[-1], synth_clip(24000, s), 24000)
    return paths


def test_cli_batches_several_inputs(tmp_path, tiny_config, monkeypatch):
    """Two inputs make one convert_batch call at the --bucket given; each
    output WAV has its clip's length; --profile writes a trace."""
    calls = []
    convert_batch = SVCPipeline.convert_batch

    def spy(self, wavs, singers, **kw):
        calls.append((self.bucket, list(singers)))
        return convert_batch(self, wavs, singers, **kw)

    monkeypatch.setattr(SVCPipeline, "convert_batch", spy)
    inputs = _inputs(tmp_path, (1.0, 0.7))
    outputs = [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    rc = cli.main(["--config", tiny_config, "--input", inputs[0], "--input", inputs[1], "--singer", "svcc_CDF1",
                   "--singer", "svcc_CDM1", "--output", outputs[0], "--output", outputs[1], "--random-weights",
                   "--device", "cpu", "--bucket", "32", "--profile", str(tmp_path / "prof")])
    assert rc == 0 and calls == [(32, ["svcc_CDF1", "svcc_CDM1"])]
    cfg = load_config(CONFIG)
    for path, seconds in zip(outputs, (1.0, 0.7)):
        samples, sr = audio_io.read_wav(path)
        assert sr == 24000 and len(samples) == mel_frame_count(cfg, int(seconds * 24000)) * 256 + 2 * 1200
    assert len(glob.glob(str(tmp_path / "prof" / "*.json"))) == 1


def test_cli_pcm16_upload_and_count_mismatch(tmp_path, tiny_config, monkeypatch):
    seen = []
    convert = SVCPipeline.convert

    def spy(self, *a, **kw):
        seen.append(kw.get("upload_pcm16"))
        return convert(self, *a, **kw)

    monkeypatch.setattr(SVCPipeline, "convert", spy)
    (wav,) = _inputs(tmp_path, (0.5,))
    out = str(tmp_path / "out.wav")
    assert cli.main(["--config", tiny_config, "--input", wav, "--singer", "svcc_CDF1", "--output", out,
                     "--random-weights", "--device", "cpu", "--pcm16-io"]) == 0
    assert seen == [True] and os.path.getsize(out) > 44
    # mismatched repeat counts are refused before anything is built
    assert cli.main(["--config", tiny_config, "--input", wav, "--input", wav, "--singer", "svcc_CDF1",
                     "--output", out, "--random-weights", "--device", "cpu"]) == 2
    assert seen == [True]
    assert np.isfinite(audio_io.read_wav(out)[0]).all()


# the port calls these leaves functionally: JAX's tree has their __call__ entries, the port's does not
FUNCTIONAL_LEAVES = ("mel_preprocess", "projection1", "projection2", "diffusion_projection", "dilated_conv",
                     "conditioner_projection", "output_projection", "skip_projection")
CAPTURE_TOL = 1e-5  # of max|JAX| per entry


def _flat(tree, prefix=()):
    """{(path..., name): tuple of arrays} of an intermediates tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_capture_intermediates_matches_jax():
    """JAX's test_capture_intermediates_replaces_stats_tuples on the same
    bridged weights (residual_layer_num=2) and inputs: the port's tree is
    JAX's without the functional leaves' __call__ entries, every sown value
    and module output within CAPTURE_TOL of max|JAX|, and the captured
    output equal, bit for bit, to an uncaptured call's."""
    import jax
    import jax.numpy as jnp

    from svc_inference_pipeline_tpu.config import load_config as jax_load_config
    from svc_inference_pipeline_tpu.models.diffsvc import DiffSVCDenoiser as JaxDenoiser
    from svc_inference_pipeline_tpu.utils.devices import fast_random_params
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.config import HParams
    from svc_inference_pipeline_tpu_torch.models.diffsvc import DiffSVCDenoiser

    mcfg = jax_load_config(CONFIG).mapper.replace(residual_layer_num=2)
    model = JaxDenoiser(mcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 100)).astype(np.float32)
    cond = rng.standard_normal((1, 8, 384)).astype(np.float32)
    t = np.array([[37]], np.int32)
    params = fast_random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond),
                                                   jnp.asarray(t)))["params"]
    want_out, want = jax_obs.capture_intermediates(model, {"params": params}, jnp.asarray(x), jnp.asarray(cond),
                                                   jnp.asarray(t))
    den = load_jax_params(DiffSVCDenoiser(HParams(**mcfg.to_dict())), jax.device_get(params))
    args = [torch.from_numpy(v) for v in (x, cond, t)]
    with torch.no_grad():
        out, got = observability.capture_intermediates(den, *args)
        plain = den(*args)
    assert torch.equal(out, plain)
    want, got = _flat(jax.device_get(want)), _flat(got)
    assert set(got) == {k for k in want if not (k[-1] == "__call__" and len(k) > 1 and k[-2] in FUNCTIONAL_LEAVES)}
    for sown in (("diffusion_embedding", "step_embedding"), ("diffusion_embedding", "step_encoder_output"),
                 ("residual_0", "noise_step_condition"), ("residual_1", "noise_step_condition")):
        assert sown in got
    for key, values in got.items():
        assert isinstance(values, tuple) and len(values) == len(want[key]) == 1, key
        for g, w in zip(jax.tree_util.tree_leaves(values), jax.tree_util.tree_leaves(want[key])):
            w = np.asarray(w)
            assert g.shape == w.shape, key
            assert np.abs(g.numpy() - w).max() <= CAPTURE_TOL * np.abs(w).max(), key
    np.testing.assert_array_equal(got[("__call__",)][0].numpy(), out.numpy())
    with torch.no_grad():  # nothing is recorded outside a capture
        observability.sow(den.residual_0, "noise_step_condition", plain)
        assert torch.equal(den(*args), plain)
