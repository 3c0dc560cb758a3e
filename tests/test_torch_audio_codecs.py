"""The port's audio input against the JAX package's: its own ctypes binding
of ``native/wav_codec.cc`` and ``native/flac_codec.cc`` (built into
``build/native/``), ``load_audio``'s dispatch on the file's first bytes, the
external decoders, and the native resampler."""

import os
import shutil
import stat
import struct
import sys
import types

import numpy as np
import pytest

from flac_fixture import write_flac
from svc_inference_pipeline_tpu.native import wav_codec as jnative
from svc_inference_pipeline_tpu.ops.resample import resample_host as jax_resample_host
from svc_inference_pipeline_tpu.utils import audio_io as jaudio
from svc_inference_pipeline_tpu_torch.native import wav_codec as native
from svc_inference_pipeline_tpu_torch.ops import resample as port_resample
from svc_inference_pipeline_tpu_torch.utils import audio_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tone_pcm(n, ch, bits, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000.0
    amp = 2 ** (bits - 2)
    base = amp * np.sin(2 * np.pi * 220.0 * t) + 0.02 * amp * rng.standard_normal(n)
    out = np.stack([np.round(base * (1.0 - 0.25 * c)).astype(np.int64) for c in range(ch)], axis=1)
    return np.clip(out, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)


def _same_decode(path, bits=16):
    """The port's read_flac equals the JAX binding's, and returns the PCM."""
    got, rate = native.read_flac(path)
    want, jrate = jnative.read_flac(path)
    assert rate == jrate and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    return np.round(got[:, 0].astype(np.float64) * 2 ** (bits - 1)).astype(np.int64), rate


@pytest.mark.parametrize("subframe", ["constant", "verbatim", "fixed1", "fixed2", "fixed3", "fixed4", "lpc"])
def test_flac_subframe_types(tmp_path, subframe):
    pcm = np.full((2048, 1), -1234, np.int64) if subframe == "constant" else _tone_pcm(4000, 1, 16, seed=1)
    path = str(tmp_path / f"{subframe}.flac")
    write_flac(path, pcm, 24000, bits=16, blocksize=1024, subframe=subframe)
    dec, rate = _same_decode(path)
    assert rate == 24000
    np.testing.assert_array_equal(dec, pcm[:, 0])


@pytest.mark.parametrize("mode", ["independent", "left-side", "right-side", "mid-side"])
def test_flac_stereo_modes_channel0(tmp_path, mode):
    pcm = _tone_pcm(3000, 2, 16, seed=2)
    path = str(tmp_path / f"{mode}.flac")
    write_flac(path, pcm, 24000, blocksize=512, mode=mode, subframe="fixed2")
    np.testing.assert_array_equal(_same_decode(path)[0], pcm[:, 0])


def test_flac_24bit(tmp_path):
    pcm = _tone_pcm(2048, 1, 24, seed=3)
    path = str(tmp_path / "b24.flac")
    write_flac(path, pcm, 48000, bits=24, subframe="fixed2")
    dec, rate = _same_decode(path, bits=24)
    assert rate == 48000
    np.testing.assert_array_equal(dec, pcm[:, 0])


@pytest.mark.parametrize("seed", range(6))
def test_flac_randomized_streams(tmp_path, seed):
    """Random signal, bits, blocksize, stereo mode and subframe type."""
    rng = np.random.default_rng(100 + seed)
    bits = int(rng.choice([16, 24]))
    blocksize = int(rng.choice([192, 576, 1024, 4096]))
    mode = str(rng.choice(["independent", "left-side", "right-side", "mid-side"]))
    subframe = str(rng.choice(["constant", "verbatim", "fixed1", "fixed2", "fixed3", "fixed4", "lpc"]))
    n = int(rng.integers(300, 9000))
    ch = 2 if mode != "independent" else int(rng.choice([1, 2]))
    amp = (1 << (bits - 2)) - 1
    if subframe == "constant":
        pcm = np.full((n, ch), int(rng.integers(-amp, amp)), np.int64)
    else:
        t = np.arange(n)[:, None]
        f = rng.uniform(30, 4000, ch)[None, :]
        pcm = np.clip((amp * 0.5 * np.sin(2 * np.pi * f * t / 24000)
                       + rng.integers(-64, 64, (n, ch))).astype(np.int64), -amp, amp)
    path = str(tmp_path / f"fuzz{seed}.flac")
    write_flac(path, pcm, 24000, bits=bits, blocksize=blocksize, mode=mode, subframe=subframe)
    np.testing.assert_array_equal(_same_decode(path, bits=bits)[0], pcm[:, 0])


def _patch_total_samples(data: bytes, total: int) -> bytes:
    """Rewrite STREAMINFO's 36-bit total_samples field."""
    b = bytearray(data)
    off = 8
    b[off + 13] = (b[off + 13] & 0xF0) | ((total >> 32) & 0x0F)
    for i, shift in enumerate((24, 16, 8, 0)):
        b[off + 14 + i] = (total >> shift) & 0xFF
    return bytes(b)


@pytest.mark.parametrize("fault,match", [("truncated", "flac decode failed"), ("overclaim", "code 3"),
                                         ("unknown_length", "unknown total_samples")])
def test_flac_faults_raise_as_in_jax(tmp_path, fault, match):
    """A truncated stream, one shorter than STREAMINFO says, and one of
    unknown length raise the JAX binding's OSError, message for message."""
    path = str(tmp_path / "ok.flac")
    write_flac(path, _tone_pcm(4000, 1, 16, seed=5), 24000)
    data = open(path, "rb").read()
    bad = str(tmp_path / f"{fault}.flac")
    with open(bad, "wb") as f:
        f.write({"truncated": data[: len(data) // 2], "overclaim": _patch_total_samples(data, 8000),
                 "unknown_length": _patch_total_samples(data, 0)}[fault])
    with pytest.raises(OSError, match=match) as ours:
        native.read_flac(bad)
    with pytest.raises(OSError) as theirs:
        jnative.read_flac(bad)
    assert str(ours.value) == str(theirs.value)


def _write_wav_raw(path, samples, rate, fmt_code, bits):
    """A RIFF/WAVE file of ``samples`` [n, ch] as they are (PCM or float)."""
    n_ch = samples.shape[1]
    if bits == 24:
        v = samples.astype("<i4").reshape(-1)
        body = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], axis=1).astype(np.uint8).tobytes()
    else:
        body = samples.astype({(1, 16): "<i2", (1, 32): "<i4", (3, 32): "<f4"}[(fmt_code, bits)]).tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt_code, n_ch, rate, rate * n_ch * bits // 8,
                                      n_ch * bits // 8, bits))
        f.write(b"data" + struct.pack("<I", len(body)) + body)


WAV_KINDS = {"pcm16": (1, 16), "pcm24": (1, 24), "pcm32": (1, 32), "float32": (3, 32)}


def _wav_file(tmp_path, kind, n=3000, ch=1, rate=24000):
    fmt_code, bits = WAV_KINDS[kind]
    if fmt_code == 3:
        samples = (0.5 * np.sin(np.arange(n * ch) / 9.0)).reshape(n, ch).astype(np.float32)
    else:
        samples = _tone_pcm(n, ch, bits, seed=7)
    path = str(tmp_path / f"{kind}_{ch}ch_{rate}.wav")
    _write_wav_raw(path, samples, rate, fmt_code, bits)
    return path


@pytest.mark.parametrize("kind", list(WAV_KINDS))
def test_native_read_wav_equals_numpy(tmp_path, kind):
    """Channel 0, normalised as load_audio normalises the numpy codec's
    integer samples (by -iinfo.min, every integer kind at its dtype's full
    scale: 24-bit PCM comes back left-justified in int32)."""
    path = _wav_file(tmp_path, kind, ch=2)
    got, rate = native.read_wav(path)
    raw, raw_rate = audio_io.read_wav(path)
    ch0 = raw[:, 0]
    full_scale = -float(np.iinfo(ch0.dtype).min) if ch0.dtype.kind == "i" else 1.0
    want = ch0.astype(np.float32) / full_scale
    assert rate == raw_rate == 24000 and got.shape == (len(raw), 1)
    np.testing.assert_array_equal(got[:, 0], want)


@pytest.mark.parametrize("kind", list(WAV_KINDS))
def test_load_audio_numpy_fallback_equals_native(tmp_path, monkeypatch, kind):
    """load_audio gives the same waveform through the native codec and
    through the numpy fallback (the native reader made to raise); 24-bit
    PCM lands at x / 2^23 on both."""
    path = _wav_file(tmp_path, kind)
    with_native, rate = audio_io.load_audio(path)

    def unavailable(_path):
        raise OSError("native codec unavailable")

    monkeypatch.setattr(native, "read_wav", unavailable)
    fallback, fallback_rate = audio_io.load_audio(path)
    assert rate == fallback_rate == 24000 and fallback.dtype == np.float32
    np.testing.assert_array_equal(fallback, with_native)
    if kind == "pcm24":
        np.testing.assert_array_equal(with_native, _tone_pcm(3000, 1, 24, seed=7)[:, 0] / np.float32(2.0**23))


@pytest.mark.parametrize("rates", [(44100, 24000), (24000, 16000), (48000, 24000), (16000, 24000)])
def test_native_resample_equals_jax(rates):
    x = np.sin(np.arange(20000) / 13.0).astype(np.float32) + 0.1 * np.random.default_rng(0).standard_normal(
        20000).astype(np.float32)
    got = native.resample(x, *rates)
    assert np.abs(got - jax_resample_host(x, *rates)).max() <= 1e-6
    assert np.abs(got - port_resample.resample_host(x, *rates)).max() == 0.0  # the port goes native
    numpy_form = port_resample.resample_host(x, *rates, quality="kaiser_fast")
    assert numpy_form.dtype == np.float32 and len(numpy_form) == len(got)


@pytest.mark.parametrize("case", ["pcm16", "float32", "stereo_44k", "flac", "flac_48k_midside"])
def test_load_audio_equals_jax(tmp_path, case):
    if case == "flac":
        path = str(tmp_path / "clip.flac")
        write_flac(path, _tone_pcm(24000, 1, 16, seed=4), 24000)
    elif case == "flac_48k_midside":
        path = str(tmp_path / "clip48.flac")
        write_flac(path, _tone_pcm(48000, 2, 16, seed=4), 48000, blocksize=4096, mode="mid-side")
    elif case == "stereo_44k":
        path = _wav_file(tmp_path, "pcm16", n=44100, ch=2, rate=44100)
    else:
        path = _wav_file(tmp_path, case, n=12000)
    got, rate = audio_io.load_audio(path, 24000)
    want, jrate = jaudio.load_audio(path, 24000)
    assert rate == jrate == 24000 and got.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_unknown_format_raises_typed_error(tmp_path, monkeypatch):
    p = tmp_path / "clip.mp3"
    p.write_bytes(b"\xff\xfb\x90\x00" + b"\x00" * 64)
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(audio_io.UnsupportedAudioFormatError, match="soundfile unavailable.*ffmpeg not on PATH"):
        audio_io.load_audio(str(p), 24000)


def test_external_decoder_reference_magnitude_rules(tmp_path, monkeypatch):
    """soundfile's output goes through the reference's magnitude rules:
    float data with |x| > 2^15 is taken as 32-bit-scaled, channel 0 kept."""
    p = tmp_path / "clip.ogg"
    p.write_bytes(b"OggS" + b"\x00" * 64)
    rate = 24000
    ch0 = (0.25 * np.sin(2 * np.pi * 220 * np.arange(rate // 2) / rate)).astype(np.float32) * 2**18
    fake = types.ModuleType("soundfile")

    def fake_read(path, always_2d=True, dtype="float32"):
        assert path == str(p)
        return np.stack([ch0, np.zeros_like(ch0)], axis=1), rate

    fake.read = fake_read
    monkeypatch.setitem(sys.modules, "soundfile", fake)
    audio, fs = audio_io.load_audio(str(p), rate)
    assert fs == rate and audio.dtype == np.float32
    np.testing.assert_allclose(audio, ch0 / (2**31 + 1), rtol=1e-6)
    np.testing.assert_array_equal(audio, jaudio.load_audio(str(p), rate)[0])


def test_external_decoder_ffmpeg_fallback(tmp_path, monkeypatch):
    """soundfile absent -> ffmpeg to a temp f32 WAV (a stub binary copies a
    WAV to the requested output); a failing ffmpeg is listed in the error."""
    src = tmp_path / "clip.mp3"
    src.write_bytes(b"\xff\xfb\x90\x00" + b"\x00" * 64)
    rate = 24000
    tone = (0.5 * np.sin(2 * np.pi * 330 * np.arange(rate // 4) / rate)).astype(np.float32)
    wav_path = tmp_path / "decoded.wav"
    audio_io.write_wav(str(wav_path), tone, rate)
    fake_ffmpeg = tmp_path / "ffmpeg"
    fake_ffmpeg.write_text(f'#!/bin/sh\nfor out do :; done\ncp "{wav_path}" "$out"\n')
    fake_ffmpeg.chmod(fake_ffmpeg.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setattr(shutil, "which", lambda name: str(fake_ffmpeg) if name == "ffmpeg" else None)
    audio, fs = audio_io.load_audio(str(src), rate)
    assert fs == rate
    np.testing.assert_allclose(audio, np.round(tone * 32767) / 32768, atol=2e-4)
    fake_ffmpeg.write_text("#!/bin/sh\necho 'Invalid data found' >&2\nexit 1\n")
    with pytest.raises(audio_io.UnsupportedAudioFormatError, match="ffmpeg failed \\(Invalid data found\\)"):
        audio_io.load_audio(str(src), rate)


def test_library_builds_under_build_native(tmp_path, monkeypatch):
    """The binding compiles into build/native/ (named by a hash of sources
    and flags), with JAX's compiler flags, and writes nothing into native/."""
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR == type(native.BUILD_DIR)(REPO) / "build" / "native"
    native_dir = os.path.join(REPO, "native")
    before = set(os.listdir(native_dir))
    commands = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        commands.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", run)
    out = native.resample(np.ones(300, np.float32), 24000, 16000)
    assert len(out) == 200
    assert native.loaded_library() == str(native.library_path())
    assert native.library_path().parent == tmp_path / "build" / "native" and native.library_path().exists()
    [cmd] = commands
    assert cmd[1:4] == ["-O2", "-shared", "-fPIC"] and cmd[-1] == "-lm"
    assert not any(arg.startswith(native_dir) and arg.endswith(".so") for arg in cmd)
    assert os.listdir(tmp_path / "build" / "native") == [native.library_path().name]
    # the JAX binding may build its own native/libsvc_native.so meanwhile
    assert set(os.listdir(native_dir)) - before <= {"libsvc_native.so"}
