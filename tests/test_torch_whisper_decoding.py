"""The port's Whisper decoding against the JAX package's: the tokenizer on a
broad corpus, the logit filters, the text decoder's logits (full prefix and
incremental), greedy / beam / sampled decoding with JAX's own Gumbel draws,
language detection, sliding-window transcription, the writers and the
front-end, on a tiny random Whisper with the same weights on both sides."""

import io
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_inference_pipeline_tpu.models import whisper_decoding as J
from svc_inference_pipeline_tpu.models.whisper import WhisperAudioEncoder as JaxEncoder
from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxDims
from svc_inference_pipeline_tpu.models.whisper import WhisperTextDecoder as JaxTextDecoder
from svc_inference_pipeline_tpu.ops import whisper_mel as jmel
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch.models import whisper_decoding as P
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperDims
from svc_inference_pipeline_tpu_torch.ops import whisper_mel as pmel

LOGIT_TOL = 2e-4  # the JAX tests' incremental-vs-full tolerance (test_whisper_decoding.py)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def corpus():
    """≥ 200 strings: contractions, digit, punctuation and whitespace runs
    (trailing ones, tabs, newlines), accented Latin, CJK, Cyrillic, Arabic,
    emoji, music symbols and JAX's non-speech symbols, then random mixes."""
    fixed = [
        "hello world", "hello singing world", "don't stop", "I'm sure it won't rain, y'all're",
        "'s 't 're 've 'm 'll 'd", "'S 'T 'RE", "it's they've we'll she'd you're I'M",
        "12345 678901234", "3.14159, 2,718!", "1,000,000 and 0.5%", "...!!! ???", "--- *** ###",
        "a  b   c    ", "tab\there\tnew\nline\r\n", "   leading", "trailing   ", "\n\n\n", " ", "",
        "\t \t", "café naïve résumé façade", "ÅÄÖ åäö ß ẞ ñ ç", "日本語のテキスト", "中文测试，标点。",
        "Привет, мир! Как дела?", "مرحبا بالعالم", "emoji 😀🎉👍🏽", "♪ la la ♪", "♪♪♪", "♩♪♫♬♭♮♯",
        "[Music] (laughs) <noise>", '"#()*+/:;<=>@[\\]^_`{|}~「」『』',
        "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪",
        "x" * 50, "ǅ ǈ ǋ ⅷ ² ½ ①", "١٢٣ ४५६", " nbsp em ideo　", "\x1c\x1dcontrol",
        "zero​width", "ﬁ ligature", "Ελληνικά", "עברית", "한국어 텍스트", "ไทย", "\u0085x y  z",
        "The quick brown fox jumps over the lazy dog.", "Mr. Smith paid $3.50 for 2 items.",
    ]
    rng = random.Random(0)
    pool = "abcXYZ 0123 .,!?'\"-\t\n日本éПр😀♪ß  '"
    mixes = ["".join(rng.choice(pool) for _ in range(rng.randint(1, 30))) for _ in range(200)]
    return fixed + mixes


@pytest.mark.parametrize("multilingual", [True, False])
def test_tokenizer_matches_jax(multilingual):
    """ids token for token, decode (also of id runs that split UTF-8
    characters), the special-token layout, sot sequences and the non-speech
    set."""
    jt, pt = J.get_tokenizer(multilingual=multilingual), P.get_tokenizer(multilingual=multilingual)
    texts = corpus()
    assert len(texts) >= 200
    for text in texts:
        ids = jt.tokenizer.encode(text, add_special_tokens=False)
        assert pt.encode(text) == ids, repr(text)
        for run in (ids, ids[::-1], ids[1:], ids[:-1], ids[::2]):
            assert pt.decode(run) == jt.decode(run), (repr(text), run)
    assert pt.encode("a<|endoftext|>b") == jt.tokenizer.encode("a<|endoftext|>b", add_special_tokens=False)
    assert len(pt.tokenizer) == len(jt.tokenizer)
    for name in ("eot", "sot", "language_tokens", "translate", "transcribe_token", "sot_lm", "sot_prev",
                 "no_speech", "no_timestamps", "timestamp_begin", "non_speech_tokens"):
        assert getattr(pt, name) == getattr(jt, name), name
    for lang in ("en", "de", "ja", "su") if multilingual else ("en",):
        for task in ("transcribe", "translate"):
            assert pt.sot_sequence(lang, task) == jt.sot_sequence(lang, task)
    ids = jt.encode(" hello world") + [jt.timestamp_begin + 54] + jt.encode(" again") + [jt.timestamp_begin]
    assert pt.decode_with_timestamps(ids) == jt.decode_with_timestamps(ids)
    assert P.build_suppress_tokens(pt) == J.build_suppress_tokens(jt)
    assert P.build_suppress_tokens(pt, "5,7") == J.build_suppress_tokens(jt, "5,7")
    assert P.build_suppress_tokens(pt, [-1, 3]) == J.build_suppress_tokens(jt, [-1, 3])


# ---------------------------------------------------------------------------
# Logit filters
# ---------------------------------------------------------------------------


def _filter_cases(tok):
    ts = tok.timestamp_begin
    begin = 3
    rows = [[1, 2, 3], [1, 2, 3, ts + 5], [1, 2, 3, 7, ts + 9], [1, 2, 3, ts + 2, ts + 4],
            [1, 2, 3, 11, 12]]
    for n in (3, 4, 5):
        tokens = np.asarray([r for r in rows if len(r) == n], np.int32)
        if len(tokens):
            yield begin, tokens


@pytest.mark.parametrize("which", ["blank", "suppress", "timestamps", "timestamps_no_initial_cap"])
def test_logit_filters_bit_equal(which):
    jt, pt = J.get_tokenizer(True), P.get_tokenizer(True)
    rng = np.random.default_rng(3)
    n_vocab = jt.timestamp_begin + 1501
    for begin, tokens in _filter_cases(jt):
        for scale in (0.1, 8.0):  # flat logits force timestamps; peaked ones do not
            logits = (scale * rng.standard_normal((len(tokens), n_vocab))).astype(np.float32)
            if which == "blank":
                jf, pf = J.SuppressBlank(jt, begin), P.SuppressBlank(pt, begin)
            elif which == "suppress":
                jf, pf = (J.SuppressTokens(J.build_suppress_tokens(jt)),
                          P.SuppressTokens(P.build_suppress_tokens(pt)))
            else:
                cap = 50 if which == "timestamps" else None
                jf, pf = J.ApplyTimestampRules(jt, begin, cap), P.ApplyTimestampRules(pt, begin, cap)
            want, got = logits.copy(), logits.copy()
            jf.apply(want, tokens)
            pf.apply(got, tokens)
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The tiny model on both sides
# ---------------------------------------------------------------------------


def _randomize_vectors(tree, rng):
    """fast_random_params zeroes every 1-D leaf: draw them instead (LayerNorm
    scales around 1)."""
    def fill(path, x):
        if np.ndim(x) >= 2:
            return np.asarray(x, np.float32)
        v = 0.1 * rng.standard_normal(np.shape(x))
        return (v + 1.0 if "scale" in str(path[-1]) else v).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _models(n_vocab):
    jt = J.get_tokenizer(True)
    fields = (80, 1500, 64, 4, 2, n_vocab, 448, 64, 4, 2)
    jdims, dims = JaxDims(*fields), WhisperDims(*fields)
    rng = np.random.default_rng(0)
    enc = _randomize_vectors(jax.device_get(fast_random_params(
        lambda: JaxEncoder(jdims).init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 3000))))["params"]), rng)
    dec = _randomize_vectors(jax.device_get(fast_random_params(
        lambda: JaxTextDecoder(jdims).init(jax.random.PRNGKey(1), jnp.zeros((1, 3), jnp.int32),
                                           jnp.zeros((1, 1500, 64))), seed=1)["params"]), rng)
    jdec = J.WhisperDecoder(jdims, enc, dec)
    pdec = P.WhisperDecoder.from_jax_params(dims, enc, dec, device="cpu")
    mel = 0.5 * np.random.default_rng(1).standard_normal((1, 80, 3000)).astype(np.float32)
    jfeats = jdec.embed_audio(jnp.asarray(mel))
    pfeats = pdec.embed_audio(mel)
    return {"jax": jdec, "port": pdec, "jt": jt, "pt": P.get_tokenizer(True), "jfeats": jfeats,
            "pfeats": pfeats}


@pytest.fixture(scope="module")
def models():
    """The JAX tests' dims: four timestamp tokens past the specials."""
    return _models(len(J.get_tokenizer(True).tokenizer) + 110)


@pytest.fixture(scope="module")
def models_full_vocab():
    """Whisper's vocabulary, 1501 timestamp tokens: the seek of a
    timestamped window moves by whole seconds, not by a few frames."""
    return _models(51865)


def test_audio_features_match_jax(models):
    np.testing.assert_allclose(models["pfeats"].numpy(), np.asarray(models["jfeats"]), rtol=1e-4, atol=1e-4)


def test_decoder_logits_full_prefix_and_incremental(models):
    """Full-prefix logits and prime + one-token steps, each within 2e-4 of
    JAX's WhisperTextDecoder and IncrementalDecoder on the same features;
    the port's own steps within 2e-4 of its full prefix."""
    jdec, pdec, tok = models["jax"], models["port"], models["jt"]
    feats = models["jfeats"]
    pfeats = torch.from_numpy(np.array(feats))  # the same features on both sides
    prefix = np.asarray([tok.sot_sequence("en") + [tok.no_timestamps, 11, 42, 7, 500, 50360]] * 2, np.int32)
    want, _ = jdec.decoder.apply({"params": jdec.decoder_params}, jnp.asarray(prefix), jnp.repeat(feats, 2, 0))
    want = np.asarray(want)
    with torch.no_grad():
        full, _ = pdec.decoder(torch.from_numpy(prefix).long(), pfeats.repeat(2, 1, 1))
    np.testing.assert_allclose(full.numpy(), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)

    jinc, pinc = jdec.incremental, pdec.incremental
    jl, jcache, joff = jinc.prime(prefix[:, :4], jnp.repeat(feats, 2, 0))
    pl, pcache, poff = pinc.prime(prefix[:, :4], pfeats.repeat(2, 1, 1))
    assert poff == joff == 4
    np.testing.assert_allclose(pl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for i in range(4, prefix.shape[1]):
        jl, jcache = jinc.step(prefix[:, i: i + 1], jnp.repeat(feats, 2, 0), jcache, joff)
        pl, pcache = pinc.step(prefix[:, i: i + 1], pfeats.repeat(2, 1, 1), pcache, poff)
        joff += 1
        poff += 1
        np.testing.assert_allclose(pl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(pl, full[:, i].numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # beam reordering gathers rows of every buffer
    swapped = pinc.reorder(pcache, [1, 0])
    for key, (k, v) in pcache.items():
        assert torch.equal(swapped[key][0], k[[1, 0]]) and torch.equal(swapped[key][1], v[[1, 0]])


def _jax_gumbel(b, n_vocab):
    """JAX's draws for one decode: PRNGKey(0), then split and gumbel per
    sampled step, as jax.random.categorical draws them in the sample loop."""
    def stream():
        key = jax.random.PRNGKey(0)
        while True:
            key, sub = jax.random.split(key)
            yield np.asarray(jax.random.gumbel(sub, (b, n_vocab), jnp.float32))

    return stream


def _assert_results_equal(got, want):
    assert got.tokens == want.tokens
    assert got.text == want.text and got.language == want.language
    assert got.temperature == want.temperature
    assert abs(got.avg_logprob - want.avg_logprob) <= 1e-3
    assert abs(got.no_speech_prob - want.no_speech_prob) <= 1e-3
    assert got.compression_ratio == want.compression_ratio


@pytest.mark.parametrize("mode", ["greedy", "greedy_timestamps", "beam_p1", "beam_p2", "sample_0.7",
                                  "sample_1.0_timestamps", "prompt_prefix"])
def test_decoding_matches_jax(models, mode):
    jdec, pdec, jt, pt = models["jax"], models["port"], models["jt"], models["pt"]
    feats, pfeats = models["jfeats"], torch.from_numpy(np.array(models["jfeats"]))
    opts = J.DecodingOptions(sample_len=10, language="en", without_timestamps="timestamps" not in mode)
    popts = P.DecodingOptions(**vars(opts))
    if mode == "greedy" or mode == "greedy_timestamps":
        want, got = jdec.greedy_decode(feats, jt, opts), pdec.greedy_decode(pfeats, pt, popts)
    elif mode.startswith("beam"):
        patience = float(mode[-1])
        want = jdec.beam_decode(feats, jt, opts, beam_size=3, patience=patience)
        got = pdec.beam_decode(pfeats, pt, popts, beam_size=3, patience=patience)
    elif mode.startswith("sample"):
        t = float(mode.split("_")[1])
        want = jdec.sample_decode(feats, jt, opts, temperature=t)
        got = pdec.sample_decode(pfeats, pt, popts, temperature=t,
                                 noise=_jax_gumbel(1, pdec.dims.n_vocab))
    else:
        kw = dict(prompt=" earlier words", prefix=[11, 12], task="translate", language="de")
        want = jdec.greedy_decode(feats, jt, J.DecodingOptions(**dict(vars(opts), **kw)))
        got = pdec.greedy_decode(pfeats, pt, P.DecodingOptions(**dict(vars(popts), **kw)))
    assert len(want.tokens) > 0
    _assert_results_equal(got, want)


def test_seeded_sampling_is_reproducible(models):
    pdec, pt, pfeats = models["port"], models["pt"], models["pfeats"]
    opts = P.DecodingOptions(sample_len=8, language="en", without_timestamps=True)
    a = pdec.sample_decode(pfeats, pt, opts, temperature=1.0)
    b = pdec.sample_decode(pfeats, pt, opts, temperature=1.0)
    assert a.tokens == b.tokens and len(a.tokens) > 0


def test_detect_language_matches_jax(models):
    want_lang, want = models["jax"].detect_language(models["jfeats"], models["jt"])
    got_lang, got = models["port"].detect_language(torch.from_numpy(np.array(models["jfeats"])), models["pt"])
    assert got_lang == want_lang and list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=0, atol=1e-4)
    assert abs(sum(got.values()) - 1.0) < 1e-3


def _segments(out):
    return [(s["start"], s["end"], s["tokens"], s["text"], float(s["temperature"]), s["seek"])
            for s in out["segments"]]


@pytest.mark.parametrize("case", ["noise_35s_two_windows", "forced_fallback", "timestamps_3s"])
def test_transcribe_matches_jax(request, case):
    """Segments (start, end, tokens, text, temperature) equal JAX's: 35 s of
    noise in two windows; the forced temperature fallback of the JAX tests
    (sampled with JAX's draws); a 3 s clip with timestamps on, at Whisper's
    vocabulary."""
    models = request.getfixturevalue("models_full_vocab" if case == "timestamps_3s" else "models")
    jdec, pdec, jt, pt = models["jax"], models["port"], models["jt"], models["pt"]
    kw = dict(no_speech_threshold=None)
    if case == "noise_35s_two_windows":
        audio = np.random.RandomState(0).randn(16000 * 35).astype(np.float32) * 0.1
        opts = dict(sample_len=4, language="en", without_timestamps=True)
    elif case == "forced_fallback":
        audio = np.zeros(16000 * 2, dtype=np.float32)
        opts = dict(sample_len=6, language="en", without_timestamps=True)
        kw.update(temperatures=(0.0, 0.5), logprob_threshold=1e9)
    else:
        audio = 0.3 * np.sin(np.arange(16000 * 3) * 0.05).astype(np.float32)
        opts = dict(sample_len=12, language="en")
    want = jdec.transcribe(audio, jt, J.DecodingOptions(**opts), **kw)
    windows = pdec.windows
    got = pdec.transcribe(audio, pt, P.DecodingOptions(**opts), noise=_jax_gumbel(1, pdec.dims.n_vocab), **kw)
    assert _segments(got) == _segments(want) and len(want["segments"]) > 0
    assert got["text"] == want["text"] and got["language"] == want["language"]
    if case == "noise_35s_two_windows":
        assert {s["seek"] for s in want["segments"]} <= {0, 3000} and pdec.windows - windows == 2
    if case == "forced_fallback":
        assert all(s["temperature"] == 0.5 for s in got["segments"])


def test_writers_byte_equal():
    segments = [dict(start=0.0, end=1.234, text=" first --> line "),
                dict(start=61.5, end=3725.0049, text="second"),
                dict(start=3725.0051, end=7322.999, text=" ♪ third ")]
    for seconds in (0.0, 0.0004, 0.0005, 1.5, 59.9995, 3600.0, 7322.999):
        for hours in (False, True):
            for marker in (".", ","):
                assert P.format_timestamp(seconds, hours, marker) == J.format_timestamp(seconds, hours, marker)
    for name in ("write_txt", "write_vtt", "write_srt"):
        got, want = io.StringIO(), io.StringIO()
        getattr(P, name)(segments, file=got)
        getattr(J, name)(segments, file=want)
        assert got.getvalue().encode() == want.getvalue().encode(), name


def test_frontend_matches_jax():
    rng = np.random.default_rng(2)
    audio = (0.3 * np.sin(np.arange(16000 * 7) * 0.031) + 0.05 * rng.standard_normal(16000 * 7)).astype(np.float32)
    got = pmel.log_mel_spectrogram_frames(audio, device="cpu")
    want = jmel.log_mel_spectrogram_frames(audio)
    assert got.shape == want.shape == (80, 700)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for n in (1000, pmel.N_SAMPLES, pmel.N_SAMPLES + 7):
        x = rng.standard_normal((2, n)).astype(np.float32)
        want = np.asarray(jmel.pad_or_trim(jnp.asarray(x)))
        np.testing.assert_array_equal(pmel.pad_or_trim(x), want)
        np.testing.assert_array_equal(pmel.pad_or_trim(torch.from_numpy(x)).numpy(), want)
        np.testing.assert_array_equal(pmel.pad_or_trim(x.T.copy(), axis=0), want.T)
    clip = rng.standard_normal(24000 * 2).astype(np.float32) * 0.1
    np.testing.assert_allclose(pmel.load_and_preprocess(clip, 24000, device="cpu").numpy(),
                               np.asarray(jmel.load_and_preprocess(clip, 24000)), rtol=0, atol=1e-5)


def test_pack_data_matches_jax():
    from svc_inference_pipeline_tpu.utils.audio_io import pack_data as jax_pack
    from svc_inference_pipeline_tpu_torch.utils.audio_io import pack_data

    data = {"melody": np.arange(7, dtype=np.float32), "singer": np.array([1], np.int32)}
    got, want = pack_data(data, device="cpu"), jax_pack(data)
    for k in data:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
