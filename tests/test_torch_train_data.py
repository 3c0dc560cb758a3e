"""Training data in the port against the JAX package: ``stft_magnitude``
with ``pad=``, ``STFT.get_mel`` with key shift 0 and 12, the acoustic
feature facade, ``FeatureExtractor`` (its npz cache too) and
``BucketedLoader`` (shuffle, crop and pad draws) on synthetic WAV clips
(f32, CPU)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from svc_inference_pipeline_tpu.ops import mel as jmel
from svc_inference_pipeline_tpu.training import data as jdata
from svc_inference_pipeline_tpu_torch.config import HParams
from svc_inference_pipeline_tpu_torch.measure import synth_clip
from svc_inference_pipeline_tpu_torch.ops import mel
from svc_inference_pipeline_tpu_torch.training import data
from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav

MEL_ATOL = 2e-4  # log-mel and normalised mel: float32 FFTs on both sides, a low bin's log moves 1.1e-4
F0_RTOL = 1e-6  # the Praat tracker's F0: 1 f32 ulp apart on some frames (1.4e-7 relative)
MAG_RTOL = 1e-4  # magnitudes, of max|JAX|
ENERGY_RTOL = 1e-4
SECONDS = (1.0, 1.5, 2.5, 0.7, 1.2)  # 94, 141, 235, 66 and 113 frames at hop 256
SINGERS = ("svcc_CDF1", "svcc_IDM1", "svcc_CDM1", "svcc_IDF1", "svcc_CDF1")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_cfg(cfg):
    return HParams(**cfg.to_dict())


@pytest.fixture(scope="module")
def clips(cfg, tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    paths = []
    for i, s in enumerate(SECONDS):
        path = str(d / f"clip{i}.wav")
        write_wav(path, np.roll(synth_clip(cfg.fs, s), 997 * i), cfg.fs)
        paths.append(path)
    return paths


@pytest.mark.parametrize("pad,mode", [((0, 0), "reflect"), ((384, 384), "reflect"), ((100, 37), "constant"),
                                      ((50, 60), "edge")])
def test_stft_magnitude_pad_matches_jax(pad, mode):
    y = np.random.default_rng(0).standard_normal((2, 3000)).astype(np.float32)
    for floor in (1e-9, 0.0):
        want = np.asarray(jmel.stft_magnitude(jnp.asarray(y), n_fft=1024, hop=120, win_length=600, pad=pad,
                                              pad_mode=mode, magnitude_floor=floor))
        got = mel.stft_magnitude(torch.from_numpy(y), 1024, 120, 600, pad=pad, pad_mode=mode,
                                 magnitude_floor=floor).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= MAG_RTOL * np.abs(want).max()


@pytest.mark.parametrize("keyshift,speed", [(0, 1), (12, 1), (0, 2), (-5, 1)])
def test_stft_get_mel_matches_jax(cfg, keyshift, speed):
    args = (cfg.fs, cfg.n_mels, cfg.n_fft, cfg.win_length, cfg.hop_length, cfg.fmin, cfg.fmax)
    y = synth_clip(cfg.fs, 0.8)[None]
    want = np.asarray(jmel.STFT(*args).get_mel(jnp.asarray(y), keyshift=keyshift, speed=speed))
    got = mel.STFT(*args).get_mel(torch.from_numpy(y), keyshift=keyshift, speed=speed).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


def test_stft_of_a_file_matches_jax(cfg, clips):
    args = (cfg.fs, cfg.n_mels, cfg.n_fft, cfg.win_length, cfg.hop_length, cfg.fmin, cfg.fmax)
    want = np.asarray(jmel.STFT(*args)(clips[0]))
    got = mel.STFT(*args)(clips[0], device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


def test_acoustic_feature_extractor_matches_jax(cfg, port_cfg, clips):
    jm, jf, je = jmel.acoustic_feature_extractor(clips[1], cfg)
    pm, pf, pe = mel.acoustic_feature_extractor(clips[1], port_cfg, device="cpu")
    assert pm.shape == jm.shape and pf.shape == jf.shape and pe.shape == je.shape
    np.testing.assert_allclose(pm, jm, rtol=0, atol=MEL_ATOL)
    np.testing.assert_allclose(pf, jf, rtol=F0_RTOL, atol=0)
    np.testing.assert_allclose(pe, je, rtol=ENERGY_RTOL, atol=1e-6)


class _Content:
    """A stand-in content extractor: the same features for both packages."""

    def extract(self, audio, n_frames):
        t = np.arange(n_frames, dtype=np.float32)[:, None]
        return np.sin(t * np.arange(1, 9, dtype=np.float32) / 7.0) * float(np.abs(audio).mean())


def _assert_feats(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_allclose(got["mel"], want["mel"], rtol=0, atol=MEL_ATOL)
    np.testing.assert_allclose(got["loudness"], want["loudness"], rtol=ENERGY_RTOL, atol=1e-6)
    np.testing.assert_allclose(got["melody"], want["melody"], rtol=F0_RTOL, atol=0)
    for k in ("wave", "singer"):
        np.testing.assert_array_equal(got[k], want[k])
    if "content_whisper" in want:
        np.testing.assert_allclose(got["content_whisper"], want["content_whisper"], rtol=1e-6)


def test_feature_extractor_matches_jax_and_caches(cfg, port_cfg, clips, tmp_path):
    want = jdata.FeatureExtractor(cfg, whisper=_Content())(clips[2], 4)
    ext = data.FeatureExtractor(port_cfg, whisper=_Content(), cache_dir=str(tmp_path / "cache"), device="cpu")
    got = ext(clips[2], 4)
    _assert_feats(got, want)
    assert (tmp_path / "cache" / "clip2.npz").is_file()
    ext.whisper = None  # a hit reads the file: no extraction runs
    cached = ext(clips[2], 7)
    assert cached["singer"].tolist() == [7]
    for k in want:
        if k != "singer":
            np.testing.assert_array_equal(cached[k], got[k])


def test_bucket_length_matches_jax():
    for n in (1, 64, 65, 200, 256, 257, 5000):
        assert data.bucket_length(n, (64, 128, 256)) == jdata.bucket_length(n, (64, 128, 256))


class _Fixed:
    """One feature dict per clip, shared by both loaders."""

    def __init__(self, feats):
        self.feats = feats

    def __call__(self, path, singer_id):
        return dict(self.feats[path], singer=np.array([singer_id], dtype=np.int32))


def test_bucketed_loader_matches_jax(cfg, port_cfg, clips):
    """Two passes of each loader over the same features: the same batches,
    bit for bit (numpy's default_rng shuffles and crops on both sides)."""
    ext = data.FeatureExtractor(port_cfg, device="cpu")
    fixed = _Fixed({p: {k: v for k, v in ext(p, 0).items() if k != "singer"} for p in clips})
    manifest = list(zip(clips, SINGERS))
    kw = dict(batch_size=2, buckets=(64, 128), seed=5, prefetch=1)
    jl = jdata.BucketedLoader(manifest, cfg, fixed, **kw)
    pl = data.BucketedLoader(manifest, port_cfg, fixed, **kw)
    for _ in range(2):
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == 2  # 5 clips: the partial batch is dropped
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
            assert g["wave"].shape[1] == g["mel"].shape[1] * cfg.hop_length


def test_bucketed_loader_with_features_from_files(cfg, port_cfg, clips, tmp_path):
    manifest = list(zip(clips[:4], SINGERS[:4]))
    jl = jdata.BucketedLoader(manifest, cfg, jdata.FeatureExtractor(cfg), batch_size=2, buckets=(128, 256), seed=1)
    pl = data.BucketedLoader(manifest, port_cfg, data.FeatureExtractor(port_cfg, cache_dir=str(tmp_path), device="cpu"),
                             batch_size=2, buckets=(128, 256), seed=1)
    want, got = list(jl), list(pl)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_feats(g, w)
    assert sorted(os.listdir(tmp_path)) == [f"clip{i}.npz" for i in range(4)]


def test_loader_raises_what_the_extractor_raises(port_cfg, clips):
    def broken(path, singer_id):
        raise OSError(f"cannot read {path}")

    loader = data.BucketedLoader(list(zip(clips[:2], SINGERS[:2])), port_cfg, broken, batch_size=2)
    with pytest.raises(OSError, match="cannot read"):
        list(loader)
