"""Checkpoint loading of the PyTorch port against the JAX package's, from
synthetic checkpoint files in the reference's on-disk layouts: a mapper
``{"state_dict"}`` behind DDP prefixes, BigVGAN ``{"generator_state_dict"}``
with every conv a weight-norm pair (resblock "1" and "2", both key styles),
and an fp16 Whisper ``{"dims", "model_state_dict"}``. The files are written
by ``chip_smoke.py``'s exporter from JAX random trees whose 1-D leaves are
randomised; the JAX converter turning them back into those trees checks the
exporter. Also the sha256 rules, the Whisper registry, the ``.npz``/``.pt``
formats, and the CLI and the server building from the files."""

import dataclasses
import hashlib
import io
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svc_inference_pipeline_tpu.checkpoints import fetch as jfetch
from svc_inference_pipeline_tpu.checkpoints import native_io as jnative_io
from svc_inference_pipeline_tpu.checkpoints import torch_convert as jtc
from svc_inference_pipeline_tpu.config import HParams as JaxHParams
from svc_inference_pipeline_tpu.models.bigvgan import BigVGANGenerator as JaxBigVGAN
from svc_inference_pipeline_tpu.models.bigvgan import vocoder_output_finalize
from svc_inference_pipeline_tpu.models.diffsvc_fast import make_fast_denoise_fn
from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxWhisperDims
from svc_inference_pipeline_tpu.pipeline.convert import SVCPipeline as JaxPipeline
from svc_inference_pipeline_tpu.sampling.ddpm import INIT_NOISE_STD, ddpm_sample
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.checkpoints import fetch, native_io
from svc_inference_pipeline_tpu_torch.checkpoints import torch_convert as tc
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import unstack_blocks
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims
from svc_inference_pipeline_tpu_torch.pipeline.convert import SVCPipeline

STEPS = 10
SINGER = "svcc_CDF1"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHISPER_DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                    n_vocab=100, n_text_ctx=16, n_text_state=64, n_text_head=4, n_text_layer=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_vectors(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x, np.float32) if np.ndim(x) >= 2 or "scale" in str(p[-1])
        else (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree,
    )


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_trees_equal(got, want, same_dtype=True):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = np.asarray(got[k])
        assert g.shape == np.shape(v), k
        assert not same_dtype or g.dtype == np.asarray(v).dtype, (k, g.dtype, np.asarray(v).dtype)
        np.testing.assert_array_equal(g, v, err_msg=str(k))


def _small_dict(cfg, resblock="1"):
    d = cfg.to_dict()
    d["compute_dtype"] = "float32"
    d["mapper"].update(noise_schedule_factors=[0.0001, 0.02, STEPS], residual_layer_num=2,
                       residual_channels=128)
    d["mapper"]["input_content_dim"]["whisper"] = WHISPER_DIMS["n_audio_state"]
    d["vocoder"]["upsample_initial_channel"] = 64
    if resblock == "2":
        d["vocoder"].update(resblock="2", resblock_dilation_sizes=[[1, 3]] * 3)
    for k in ("singer_file", "min_mel_file", "max_mel_file", "target_f0_file"):
        d[k] = os.path.normpath(os.path.join(REPO, d[k]))
    return d


@pytest.fixture(scope="module")
def files(cfg, tmp_path_factory):
    """JAX random trees (1-D leaves randomised, Whisper rounded to fp16) and
    the reference-layout files written from them."""
    tmp = tmp_path_factory.mktemp("ckpts")
    d = _small_dict(cfg)
    jpipe = JaxPipeline.from_config(JaxHParams(**d), random_weights=True,
                                    whisper_size=JaxWhisperDims(**WHISPER_DIMS))
    rng = np.random.default_rng(0)
    cond, den, voc, whisper = (_randomize_vectors(jax.device_get(t), rng) for t in
                               (jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params,
                                jpipe.whisper.params))
    whisper = jax.tree_util.tree_map(lambda x: x.astype(np.float16).astype(np.float32), whisper)
    d2 = _small_dict(cfg, resblock="2")
    vcfg2 = JaxHParams(**d2).vocoder
    voc2 = fast_random_params(lambda: JaxBigVGAN(vcfg2).init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 100))),
                              seed=5)["params"]
    voc2 = _randomize_vectors(jax.device_get(voc2), rng)
    paths = {k: str(tmp / f"{k}.pt") for k in ("mapper", "vocoder", "vocoder2", "whisper")}
    torch.save(chip_smoke.mapper_checkpoint(cond, den), paths["mapper"])
    torch.save(chip_smoke.vocoder_checkpoint(voc, JaxHParams(**d).vocoder, rng), paths["vocoder"])
    torch.save(chip_smoke.vocoder_checkpoint(voc2, vcfg2, rng), paths["vocoder2"])
    torch.save(chip_smoke.whisper_checkpoint(WHISPER_DIMS, whisper, rng), paths["whisper"])
    d.update(svc_model_path=paths["mapper"], vocoder_model_path=paths["vocoder"], whisper_model=paths["whisper"])
    return {"dict": d, "dict2": d2, "paths": paths, "cond": cond, "den": den, "voc": voc, "voc2": voc2,
            "whisper": whisper}


def test_exported_files_convert_back_to_the_trees(files):
    """The JAX converter turns the written files back into the JAX trees:
    exactly, but for the folded weights (float rounding of g v / |v|)."""
    mcfg = JaxHParams(**files["dict"]).mapper
    enc, den = jtc.load_mapper_params(files["paths"]["mapper"], mcfg)
    _assert_trees_equal(enc, files["cond"])
    _assert_trees_equal(den, files["den"])
    for name, tree, d in (("vocoder", files["voc"], files["dict"]), ("vocoder2", files["voc2"], files["dict2"])):
        got = dict(_leaves(jtc.load_vocoder_params(files["paths"][name], JaxHParams(**d).vocoder)))
        want = dict(_leaves(tree))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k[-1] == "kernel":
                np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7 * np.abs(v).max(), err_msg=str(k))
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    dims, params = jtc.load_whisper(files["paths"]["whisper"])
    assert dims == WHISPER_DIMS
    _assert_trees_equal(params["encoder"], jax.tree_util.tree_map(lambda x: x.astype(np.float16), files["whisper"]))
    assert params["decoder"]["token_embedding"]["embedding"].shape == (100, 64)
    ckpt = torch.load(files["paths"]["vocoder"], weights_only=False)["generator_state_dict"]
    g_keys = [k for k in ckpt if k.startswith("ups.0.0.") and k.endswith(("weight_g", "original0"))]
    assert [tuple(ckpt[k].shape) for k in g_keys] == [(64, 1, 1)]  # ConvTranspose1d [Cin, Cout, K]: g at dim 0
    assert any(k.endswith("weight_g") for k in ckpt) and any(k.endswith("original1") for k in ckpt)


@pytest.mark.parametrize("name", ["mapper", "vocoder", "vocoder2", "whisper_encoder", "whisper_full"])
def test_converters_equal_jax(files, name):
    """The port's converters return JAX's trees: same keys, dtypes and bits."""
    if name == "mapper":
        sd = torch.load(files["paths"]["mapper"], weights_only=False)["state_dict"]
        cfg = JaxHParams(**files["dict"]).mapper
        got, want = tc.convert_mapper_state_dict(sd, cfg), jtc.convert_mapper_state_dict(sd, cfg)
        got, want = dict(zip(("enc", "den"), got)), dict(zip(("enc", "den"), want))
    elif name.startswith("vocoder"):
        sd = torch.load(files["paths"][name], weights_only=False)["generator_state_dict"]
        vcfg = JaxHParams(**files["dict" if name == "vocoder" else "dict2"]).vocoder
        got, want = tc.convert_vocoder_state_dict(sd, vcfg), jtc.convert_vocoder_state_dict(sd, vcfg)
    else:
        sd = torch.load(files["paths"]["whisper"], weights_only=False)["model_state_dict"]
        enc_only = name == "whisper_encoder"
        got = tc.convert_whisper_state_dict(sd, encoder_only=enc_only)
        want = jtc.convert_whisper_state_dict(sd, encoder_only=enc_only)
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("dim,new_style", [(0, False), (0, True), (2, False), (2, True)])
def test_fold_weight_norm_matches_jax_and_torch(dim, new_style):
    """fold_weight_norm equals JAX's bit for bit, and is within one f32 ulp
    of torch._weight_norm evaluated in float64 (dim inferred from g)."""
    rng = np.random.default_rng(dim)
    v = rng.standard_normal((6, 5, 7)).astype(np.float32)
    g_shape = [1, 1, 1]
    g_shape[dim] = v.shape[dim]
    g = rng.uniform(0.5, 2.0, g_shape).astype(np.float32)
    gk, vk = chip_smoke.WN_NEW_STYLE if new_style else chip_smoke.WN_OLD_STYLE
    sd = {f"conv.{gk}": g, f"conv.{vk}": v, "conv.bias": rng.standard_normal(6).astype(np.float32)}
    got, want = tc.fold_weight_norm(sd), jtc.fold_weight_norm(sd)
    _assert_trees_equal(got, want)
    ref = torch._weight_norm(torch.from_numpy(v).double(), torch.from_numpy(g).double(), dim).float().numpy()
    assert np.all(np.abs(got["conv.weight"] - ref) <= np.spacing(np.abs(ref)))


@pytest.fixture(scope="module")
def loaded(files):
    """The port's and the JAX package's pipelines from the same files."""
    port = SVCPipeline.from_config(HParams(**files["dict"]), device="cpu")
    jpipe = JaxPipeline.from_config(JaxHParams(**files["dict"]))
    return port, jpipe


def test_from_config_state_dict_equals_jax_loader(loaded):
    """SVCPipeline.from_config from the files holds, bit for bit, what
    from_jax_params makes of the trees that JAX's from_config loaded."""
    port, jpipe = loaded
    trees = [jax.device_get(t) for t in (jpipe.cond_params, jpipe.denoiser_params, jpipe.vocoder_params,
                                         jpipe.whisper.params)]
    dims = WhisperDims(**dataclasses.asdict(jpipe.whisper.dims))
    ref = SVCPipeline.from_jax_params(HParams(**jpipe.cfg.to_dict()), *trees[:3], dims,
                                      unstack_blocks(trees[3], dims.n_audio_layer), device="cpu")
    assert port.whisper.dims == dims
    for a, b in ((port.cond_encoder, ref.cond_encoder), (port.denoiser, ref.denoiser),
                 (port.vocoder, ref.vocoder), (port.whisper.encoder, ref.whisper.encoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_convert_core_from_files_matches_jax(loaded):
    """_convert_core of the loaded port pipeline on JAX's batch and noise,
    within 1e-3 of the JAX modules applied one by one on the loaded trees
    (the tolerance of tests/test_torch_pipeline.py)."""
    port, jpipe = loaded
    fs = 24000
    t = np.arange(int(1.0 * fs)) / fs
    clip = (0.3 * np.sin(2 * np.pi * np.cumsum(220.0 * 2 ** (0.5 / 12 * np.sin(2 * np.pi * 5.5 * t))) / fs)
            ).astype(np.float32)
    jbatch, n_frames = jpipe.extract_features(clip, SINGER)
    padded = jbatch["melody"].shape[1]
    key = jax.random.PRNGKey(3)
    n_true = jnp.asarray([n_frames], jnp.int32)
    shape = (1, padded, 100)
    cond = jpipe.cond_encoder.apply({"params": jpipe.cond_params}, jbatch)
    fn = make_fast_denoise_fn(jpipe.denoiser_params, cond, STEPS, jpipe.cfg.mapper, compute_dtype=jnp.float32)
    mel_norm = ddpm_sample(fn, cond, key, shape, jpipe.schedule)
    mel = (mel_norm + 1.0) / 2.0 * (jpipe._mel_max - jpipe._mel_min + 1e-12) + jpipe._mel_min
    wave = jpipe.vocoder.apply({"params": jpipe.vocoder_params}, mel)
    chain = np.asarray(vocoder_output_finalize(wave[..., : padded * 256], n_true, 256))

    k2, init_key = jax.random.split(key)
    noise = (torch.from_numpy(np.array(INIT_NOISE_STD * jax.random.normal(init_key, shape))),
             torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, shape)) for k in jax.random.split(k2, STEPS)])))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    got = port._convert_core(batch, torch.tensor([n_frames]), padded, noise=noise).numpy()
    assert got.shape == chain.shape == (1, padded * 256)
    assert np.abs(got - chain).max() <= 1e-3


# ---------------------------------------------------------------------------
# sha256 rules (the cases of tests/test_checkpoint_files.py)
# ---------------------------------------------------------------------------


def test_file_sha256_matches_hashlib(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"svc" * 12345)
    assert tc.file_sha256(str(p)) == hashlib.sha256(b"svc" * 12345).hexdigest() == jtc.file_sha256(str(p))


def test_verify_sha256_raises_on_mismatch(tmp_path):
    p = tmp_path / "ckpt.pt"
    p.write_bytes(b"not the advertised bytes")
    with pytest.raises(RuntimeError, match="SHA256 checksum does not match"):
        tc.verify_sha256(str(p), "0" * 64)


@pytest.mark.parametrize("loader", ["mapper", "vocoder"])
def test_loaders_reject_a_bad_digest_before_load(tmp_path, loader):
    p = tmp_path / f"{loader}.pt"
    p.write_bytes(b"\x00garbage, never torch.load-ed")
    fn = tc.load_mapper_params if loader == "mapper" else tc.load_vocoder_params
    with pytest.raises(RuntimeError, match="SHA256"):
        fn(str(p), None, expected_sha256="f" * 64)


def test_load_whisper_checks_official_names(tmp_path, monkeypatch):
    """A file named after an official model is checked against the digest
    table; an explicit digest of its bytes passes; verify=False skips."""
    p = tmp_path / "medium.pt"
    p.write_bytes(b"wrong contents for the official medium model")
    with pytest.raises(RuntimeError, match="SHA256"):
        tc.load_whisper(str(p))
    seen = []
    monkeypatch.setattr(tc, "_torch_load", lambda path: seen.append(path) or
                        {"dims": {"n_mels": 80}, "model_state_dict": {}})
    monkeypatch.setattr(tc, "convert_whisper_state_dict", lambda sd, encoder_only: {})
    assert tc.load_whisper(str(p), expected_sha256=tc.file_sha256(str(p)))[0] == {"n_mels": 80}
    assert tc.load_whisper(str(p), verify=False)[0] == {"n_mels": 80}
    assert seen == [str(p)] * 2


def test_unknown_name_skips_table(tmp_path, monkeypatch):
    p = tmp_path / "custom_finetune.pt"
    p.write_bytes(b"anything")
    monkeypatch.setattr(tc, "_torch_load", lambda path: {"dims": {}, "model_state_dict": {}})
    monkeypatch.setattr(tc, "convert_whisper_state_dict", lambda sd, encoder_only: {})
    assert tc.load_whisper(str(p))[0] == {}
    assert tc.WHISPER_SHA256 == jtc.WHISPER_SHA256


# ---------------------------------------------------------------------------
# The Whisper registry (the cases of tests/test_fetch.py, on the port's module)
# ---------------------------------------------------------------------------


class _FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _with_digest(monkeypatch, payload: bytes, name="tiny"):
    monkeypatch.setitem(fetch.WHISPER_SHA256, name, hashlib.sha256(payload).hexdigest())


def test_urls_follow_reference_registry_format():
    assert fetch.WHISPER_URLS == jfetch.WHISPER_URLS
    for name, url in fetch.WHISPER_URLS.items():
        assert tc.WHISPER_SHA256[name] in url and url.endswith(".pt")
    assert fetch.WHISPER_URLS["large"].endswith("large-v2.pt")


def test_download_gate_blocks_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("SVC_ALLOW_DOWNLOAD", raising=False)
    assert not fetch.download_allowed()
    with pytest.raises(FileNotFoundError, match="SVC_ALLOW_DOWNLOAD"):
        fetch.fetch_whisper_checkpoint("tiny", cache_dir=str(tmp_path))


def test_fetch_download_verify_and_cache(tmp_path, monkeypatch):
    payload = b"model-bytes" * 100
    _with_digest(monkeypatch, payload)
    calls = []

    def urlopen(url):
        calls.append(url)
        return _FakeResponse(payload)

    path = fetch.fetch_whisper_checkpoint("tiny", cache_dir=str(tmp_path), allow_download=True, _urlopen=urlopen)
    assert open(path, "rb").read() == payload and calls == [fetch.WHISPER_URLS["tiny"]]
    path2 = fetch.fetch_whisper_checkpoint("tiny", cache_dir=str(tmp_path), allow_download=False,
                                           _urlopen=urlopen)
    assert path2 == path and len(calls) == 1


def test_fetch_redownloads_corrupt_cache(tmp_path, monkeypatch):
    payload = b"good-model-bytes" * 64
    _with_digest(monkeypatch, payload)
    (tmp_path / "tiny.pt").write_bytes(b"corrupt")
    path = fetch.fetch_whisper_checkpoint("tiny", cache_dir=str(tmp_path), allow_download=True,
                                          _urlopen=lambda url: _FakeResponse(payload))
    assert open(path, "rb").read() == payload


def test_fetch_rejects_corrupt_download(tmp_path, monkeypatch):
    _with_digest(monkeypatch, b"expected-bytes")
    with pytest.raises(RuntimeError, match="sha256"):
        fetch.fetch_whisper_checkpoint("tiny", cache_dir=str(tmp_path), allow_download=True,
                                       _urlopen=lambda url: _FakeResponse(b"tampered-bytes"))
    assert not os.listdir(tmp_path)


def test_unknown_model_name(tmp_path):
    with pytest.raises(KeyError, match="unknown whisper model"):
        fetch.fetch_whisper_checkpoint("huge", cache_dir=str(tmp_path))


def test_registry_name_without_cache_raises_or_falls_back(files, tmp_path, monkeypatch):
    """A registry name with nothing cached and downloads off raises
    FileNotFoundError; SVC_ALLOW_RANDOM_WHISPER=1 warns and runs random
    Whisper weights at the configured size (tiny)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.delenv("SVC_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.delenv("SVC_ALLOW_RANDOM_WHISPER", raising=False)
    d = dict(files["dict"], whisper_model="tiny", svc_model_path=str(tmp_path / "absent.pt"))
    with pytest.raises(FileNotFoundError, match="whisper checkpoint 'tiny' unavailable"):
        SVCPipeline.from_config(HParams(**d), device="cpu")
    monkeypatch.setenv("SVC_ALLOW_RANDOM_WHISPER", "1")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("svc_tpu.pipeline")
    logger.addHandler(handler)
    try:
        pipe = SVCPipeline.from_config(HParams(**d), device="cpu")
    finally:
        logger.removeHandler(handler)
    assert any("RANDOM weights" in r.getMessage() for r in records)
    assert pipe.whisper.dims.n_audio_state == 384 and pipe.cfg.mapper.input_content_dim["whisper"] == 384
    voc = tc.load_vocoder_params(files["paths"]["vocoder"], HParams(**d).vocoder)
    np.testing.assert_array_equal(pipe.vocoder.conv_pre.conv.bias.detach().numpy(), voc["conv_pre"]["conv"]["bias"])
    wave = pipe.convert(np.sin(np.arange(6000) / 10).astype(np.float32), SINGER,
                        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(wave).all()


def test_missing_mapper_and_vocoder_warn_and_draw_as_random_weights(cfg, tmp_path, monkeypatch):
    """A mapper or vocoder file that does not exist goes random with a
    warning that names the missing path, and the weights drawn are those of
    ``random_weights=True``: the same draws from the one generator, in the
    same order."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.delenv("SVC_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.setenv("SVC_ALLOW_RANDOM_WHISPER", "1")
    absent = {"svc_model_path": str(tmp_path / "no_mapper.pt"),
              "vocoder_model_path": str(tmp_path / "no_vocoder.pt")}
    d = dict(_small_dict(cfg), whisper_model="tiny", **absent)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("svc_tpu.pipeline")
    logger.addHandler(handler)
    try:
        pipe = SVCPipeline.from_config(HParams(**d), device="cpu")
    finally:
        logger.removeHandler(handler)
    messages = [r.getMessage() for r in records]
    for what, key in (("mapper", "svc_model_path"), ("vocoder", "vocoder_model_path")):
        assert any(what in m and absent[key] in m and "RANDOM weights" in m for m in messages), messages
    ref = SVCPipeline.from_config(HParams(**d), random_weights=True, whisper_size="tiny", device="cpu")
    for name in ("cond_encoder", "denoiser", "vocoder"):
        got, want = getattr(pipe, name).state_dict(), getattr(ref, name).state_dict()
        assert sorted(got) == sorted(want), name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    for k, v in ref.whisper.encoder.state_dict().items():
        assert torch.equal(pipe.whisper.encoder.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# Converted-tree files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_written_by_either_package_loads_in_the_other(files, tmp_path, writer):
    tree = {"enc": files["cond"], "den": files["den"]}
    path = str(tmp_path / "sub" / "mapper.npz")
    save, load = ((jnative_io.save_checkpoint, native_io.load_checkpoint) if writer == "jax"
                  else (native_io.save_checkpoint, jnative_io.load_checkpoint))
    save(path, tree)
    _assert_trees_equal(load(path), tree)


def test_pt_round_trip(files, tmp_path):
    tree = {"voc": files["voc"], "whisper": files["whisper"]}
    path = str(tmp_path / "converted.pt")
    native_io.save_checkpoint(path, tree)
    _assert_trees_equal(native_io.load_checkpoint(path), tree)


# ---------------------------------------------------------------------------
# Entry points from the files
# ---------------------------------------------------------------------------


def test_cli_runs_from_checkpoint_files(files, tmp_path):
    """cli.main with no --random-weights loads the files of --config."""
    from svc_inference_pipeline_tpu_torch import cli
    from svc_inference_pipeline_tpu_torch.utils import audio_io

    (tmp_path / "cfg.json").write_text(json.dumps(files["dict"]))
    audio_io.write_wav(str(tmp_path / "in.wav"), 0.4 * np.sin(2 * np.pi * 200 * np.arange(12000) / 24000), 24000)
    built = {}
    rc = cli.main(["--config", str(tmp_path / "cfg.json"), "--input", str(tmp_path / "in.wav"), "--singer", SINGER,
                   "--output", str(tmp_path / "out.wav"), "--device", "cpu"], built=built)
    assert rc == 0
    samples, sr = audio_io.read_wav(str(tmp_path / "out.wav"))
    assert sr == 24000 and len(samples) > 2 * 1200 and np.isfinite(samples).all()
    enc, _ = tc.load_mapper_params(files["paths"]["mapper"], HParams(**files["dict"]).mapper)
    np.testing.assert_array_equal(built["pipeline"].cond_encoder.singer.weight.detach().numpy(),
                                  enc["singer"]["embedding"])


def test_server_builds_from_checkpoint_files(files, tmp_path, monkeypatch):
    """serving.main with no --random-weights builds its pipeline from the
    files of --config (the HTTP loop is stubbed out)."""
    from svc_inference_pipeline_tpu_torch import serving

    (tmp_path / "cfg.json").write_text(json.dumps(files["dict"]))
    seen = {}

    class _Httpd:
        server_address = ("127.0.0.1", 0)

        def __init__(self, pipeline):
            self.svc = type("Svc", (), {"close": lambda self: seen.setdefault("closed", True)})()
            seen["pipeline"] = pipeline

        def serve_forever(self):
            seen["served"] = True

        def server_close(self):
            pass

    monkeypatch.setattr(serving, "serve", lambda cfg, pipeline, *a, **k: _Httpd(pipeline))
    assert serving.main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu", "--port", "0"]) == 0
    assert seen["served"] and seen["closed"]
    _, den = tc.load_mapper_params(files["paths"]["mapper"], HParams(**files["dict"]).mapper)
    np.testing.assert_array_equal(seen["pipeline"].denoiser.residual_1.dilated_conv.bias.detach().numpy(),
                                  den["residual_1"]["dilated_conv"]["bias"])


def test_conv2d_bridge_rule():
    """A flax Conv's kernel [kh, kw, Cin, Cout] -> nn.Conv2d's [Cout, Cin, kh,
    kw]: the same outputs on an NHWC / NCHW input (strided, padded as the
    period discriminator's); random_init_ draws it with fan-in Cin kh kw."""
    import flax.linen as fnn

    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_

    rng = np.random.default_rng(2)
    params = {"kernel": rng.standard_normal((5, 3, 4, 8)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32)}
    x = rng.standard_normal((2, 4, 17, 6)).astype(np.float32)  # NCHW
    want = fnn.Conv(8, (5, 3), strides=(3, 2), padding=[(2, 2), (1, 1)]).apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    conv = torch.nn.Conv2d(4, 8, (5, 3), stride=(3, 2), padding=(2, 1))
    load_jax_params(conv, params)
    np.testing.assert_array_equal(conv.weight.detach().numpy(), params["kernel"].transpose(3, 2, 0, 1))
    got = conv(torch.from_numpy(x)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    random_init_(conv, torch.Generator().manual_seed(0))
    assert abs(float(conv.weight.detach().std()) - (4 * 5 * 3) ** -0.5) < 0.03 and not conv.bias.any()
