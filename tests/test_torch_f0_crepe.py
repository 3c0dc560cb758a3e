"""The port's CREPE (``ops/f0_crepe.py``) against the JAX package's: the net
on the same parameters at capacity "tiny" and "full" within 1e-5,
``load_crepe_params`` on a torchcrepe-layout file equal to JAX's, the
framing, decode, filters and loudness bit for bit, the whole chain on a tone,
and the ``SVC_CREPE_WEIGHTS`` / missing-weights rules. Also the weights
bridge: strict on JAX's ``init_params`` tree and on the converted file, and
the random init's scale of 1."""

import numpy as np
import pytest
import torch

import chip_smoke
from svc_inference_pipeline_tpu.ops import f0_crepe as J
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
from svc_inference_pipeline_tpu_torch.ops import f0_crepe as P

FS16 = 16000
NET_TOL = 1e-5  # f32 convs summed in another order (the JAX suite's oracle bound)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n, seed=11, hop=160):
    x = (0.3 * np.random.default_rng(seed).standard_normal(FS16)).astype(np.float32)
    return P.frame_audio(x, hop)[:n]


def _tone(f0_hz=220.0, seconds=0.5, fs=24000):
    t = np.arange(int(seconds * fs)) / fs
    x = sum((0.5 / k) * np.sin(2 * np.pi * k * f0_hz * t) for k in range(1, 5))
    return x.astype(np.float32)


def _randomized_init(model, seed=0):
    """JAX's ``init_params`` tree with its 1-D leaves drawn too (the init
    gives bias 0, scale 1, shift 0, which would hide a mix-up of them)."""
    rng = np.random.default_rng(seed)
    params = J.CrepeModel(model).init_params(rng)
    for p in params.values():
        for k in ("bias", "scale", "shift"):
            if k in p:
                p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("model,n_frames", [("tiny", 12), ("full", 3)])
def test_net_matches_jax_apply(model, n_frames, monkeypatch):
    params = _randomized_init(model)
    frames = _frames(n_frames)
    ref = np.asarray(J.CrepeModel(model).apply(params, frames))
    net = P.build_crepe(params, model, "cpu")
    got = P.crepe_probs(net, frames)
    assert got.shape == ref.shape == (n_frames, P.N_BINS)
    np.testing.assert_allclose(got, ref, rtol=0, atol=NET_TOL)
    # chunks of frames give the rows of one call
    monkeypatch.setattr(P, "CHUNK_FRAMES", 2)
    np.testing.assert_allclose(P.crepe_probs(net, frames), got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model,n_frames", [("tiny", 12), ("full", 3)])
def test_load_crepe_params_matches_jax(model, n_frames, tmp_path):
    """The converted tree equals JAX's leaf for leaf; the net on it within
    1e-5 of JAX's apply (BN after the ReLU with non-trivial statistics)."""
    path = tmp_path / f"{model}.pth"
    torch.save(chip_smoke.crepe_checkpoint(model, np.random.default_rng(7)), path)
    ours, theirs = P.load_crepe_params(str(path), model), J.load_crepe_params(str(path), model)
    assert ours.keys() == theirs.keys()
    for name in theirs:
        assert ours[name].keys() == theirs[name].keys()
        for leaf in theirs[name]:
            assert ours[name][leaf].dtype == theirs[name][leaf].dtype
            np.testing.assert_array_equal(ours[name][leaf], theirs[name][leaf])
    frames = _frames(n_frames, seed=3)
    ref = np.asarray(J.CrepeModel(model).apply(theirs, frames))
    np.testing.assert_allclose(P.crepe_probs(P.build_crepe(ours, model, "cpu"), frames), ref, rtol=0, atol=NET_TOL)


def test_bridge_is_strict_and_random_init_keeps_scale():
    net = P.CrepeModel("tiny")
    params = _randomized_init("tiny")
    load_jax_params(net, params)
    np.testing.assert_array_equal(net.conv3.scale.detach().numpy(), params["conv3"]["scale"])
    np.testing.assert_array_equal(net.conv0.weight.detach().numpy(), params["conv0"]["kernel"].transpose(2, 1, 0))
    del params["conv2"]["shift"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(P.CrepeModel("tiny"), params)
    rand = P.build_crepe(None, "tiny", "cpu", generator=torch.Generator().manual_seed(0))
    for i in range(6):
        block = getattr(rand, f"conv{i}")
        assert (block.scale == 1).all() and (block.shift == 0).all() and (block.bias == 0).all()
    assert np.ptp(P.crepe_probs(rand, _frames(4))) > 0  # the features do not collapse


def test_frame_decode_filters_loudness_bit_equal():
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(FS16)).astype(np.float32)
    for hop in (80, 160):
        np.testing.assert_array_equal(P.frame_audio(x, hop), J.frame_audio(x, hop))
        np.testing.assert_array_equal(P.a_weighted_loudness(x, hop), J.a_weighted_loudness(x, hop))
    probs = rng.random((40, P.N_BINS)) ** 8
    probs[:, 150] += 0.5
    for lo, hi in ((50.0, 2006.0), (65.0, 800.0)):
        for a, b in zip(P.viterbi_decode(probs, lo, hi), J.viterbi_decode(probs, lo, hi)):
            np.testing.assert_array_equal(a, b)
    v = np.array([1.0, 5.0, np.nan, 2.0, 2.0, 9.0, 0.0])
    for win in (3, 5):
        np.testing.assert_array_equal(P.median_filter(v, win), J.median_filter(v, win))
        np.testing.assert_array_equal(P.mean_filter(v, win), J.mean_filter(v, win))
    bins = np.arange(P.N_BINS)
    np.testing.assert_array_equal(P.cents_to_freq(P.bins_to_cents(bins)), J.cents_to_freq(J.bins_to_cents(bins)))
    np.testing.assert_array_equal(P.freq_to_cents([55.0, 440.0]), J.freq_to_cents([55.0, 440.0]))


def test_full_chain_on_a_tone_matches_jax():
    """The chain at capacity "tiny" on a 0.5 s tone with silence after it:
    f0 within 1e-6 relative of JAX's (the nets' probabilities differ by
    float rounding, below the decode's ties; a flipped Viterbi choice would
    move a frame by a bin, 20 cents = 1.2e-2), zeros on the silent tail."""
    params = _randomized_init("tiny", seed=4)
    audio = np.concatenate([_tone(), np.zeros(6000, np.float32)])
    mel_len = len(audio) // 256
    args = (audio, mel_len, 24000, 256, 160, 50.0, 1100.0)
    want = J.get_f0_features_using_crepe(*args, threshold=0.0, model="tiny", params=params)
    got = P.get_f0_features_using_crepe(*args, threshold=0.0, model="tiny", params=params, device="cpu")
    assert got.shape == want.shape == (mel_len,)
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    silent = P.get_f0_features_using_crepe(np.zeros(12000, np.float32), 40, 24000, 256, 160, 50.0, 1100.0,
                                           model="tiny", params=params, device="cpu")
    assert (silent == 0).all()


def test_missing_weights_raise(monkeypatch):
    monkeypatch.delenv("SVC_CREPE_WEIGHTS", raising=False)
    for mod in (P, J):
        with pytest.raises(NotImplementedError, match="SVC_CREPE_WEIGHTS"):
            mod.get_f0_features_using_crepe(np.zeros(24000, np.float32), 100, 24000, 256, 160, 50.0, 1100.0)
    monkeypatch.setenv("SVC_CREPE_WEIGHTS", "/nonexistent/full.pth")
    with pytest.raises(NotImplementedError, match="SVC_CREPE_WEIGHTS"):
        P.crepe_predict(np.zeros(16000, np.float32), 160, 50.0, 1100.0, device="cpu")


def test_env_var_weights_load_once(tmp_path, monkeypatch):
    """SVC_CREPE_WEIGHTS names a torchcrepe file: it is converted once per
    (path, model) and cached, and the chain equals the one given the same
    weights by ``params=``."""
    path = tmp_path / "tiny.pth"
    torch.save(chip_smoke.crepe_checkpoint("tiny", np.random.default_rng(3)), path)
    monkeypatch.setenv("SVC_CREPE_WEIGHTS", str(path))
    monkeypatch.setattr(P, "_PARAM_CACHE", {})
    audio = _tone(seconds=0.3)
    f0 = P.get_f0_features_using_crepe(audio, 28, 24000, 256, 160, 50.0, 1100.0, model="tiny", device="cpu")
    assert list(P._PARAM_CACHE) == [(str(path), "tiny")]
    want = P.get_f0_features_using_crepe(audio, 28, 24000, 256, 160, 50.0, 1100.0, model="tiny",
                                         params=P.load_crepe_params(str(path), "tiny"), device="cpu")
    assert f0.shape == (28,) and np.isfinite(f0).all()
    np.testing.assert_array_equal(f0, want)
