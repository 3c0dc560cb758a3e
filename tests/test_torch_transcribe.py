"""The port's transcription CLI against the JAX package's: the same tiny
reference-layout Whisper file (chip_smoke's exporter) and the same WAV give
byte-equal .txt/.vtt/.srt; the parser has JAX's flags with --device for
--cpu; the weights bridge loads the text decoder strictly from JAX's tree and
from load_whisper's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svc_inference_pipeline_tpu import transcribe as jax_transcribe
from svc_inference_pipeline_tpu.checkpoints.torch_convert import load_whisper as jax_load_whisper
from svc_inference_pipeline_tpu.models.whisper import WhisperDims as JaxDims
from svc_inference_pipeline_tpu.models.whisper import WhisperTextDecoder as JaxTextDecoder
from svc_inference_pipeline_tpu.utils.devices import fast_random_params
from svc_inference_pipeline_tpu_torch import transcribe
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_
from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import load_whisper
from svc_inference_pipeline_tpu_torch.models.whisper import WhisperAudioEncoder, WhisperDims, WhisperTextDecoder
from svc_inference_pipeline_tpu_torch.utils.audio_io import write_wav

DIMS = WhisperDims(80, 1500, 64, 4, 2, 51865, 448, 64, 4, 2)


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
def whisper_file(tmp_path_factory):
    """A tiny Whisper in OpenAI's file layout (fp16), written by chip_smoke's
    exporter: a random encoder with random vectors, a random text decoder."""
    tmp = tmp_path_factory.mktemp("whisper")
    enc = WhisperAudioEncoder(DIMS)
    g = torch.Generator().manual_seed(3)
    random_init_(enc, g)
    chip_smoke.randomize_vectors_(enc, g)
    path = str(tmp / "tiny-synthetic.pt")
    rng = np.random.default_rng(3)
    torch.save(chip_smoke.whisper_checkpoint(dataclasses.asdict(DIMS), chip_smoke.module_tree(enc), rng), path)
    return path


def test_parser_has_jax_flags_with_device_for_cpu():
    ours = {a.dest: a for a in transcribe.build_parser()._actions}
    theirs = {a.dest: a for a in jax_transcribe.build_parser()._actions}
    assert set(ours) - {"device"} == set(theirs) - {"cpu"}
    for dest, action in theirs.items():
        if dest != "cpu":
            assert (ours[dest].option_strings, ours[dest].default, ours[dest].choices, ours[dest].nargs) == (
                action.option_strings, action.default, action.choices, action.nargs), dest
    assert ours["device"].default == "cuda"
    a = transcribe.build_parser().parse_args(["x.wav", "--model", "tiny", "--beam_size", "3", "--task",
                                              "translate", "--output_format", "srt", "--device", "cpu"])
    assert a.audio == ["x.wav"] and a.beam_size == 3 and a.task == "translate" and a.device == "cpu"
    assert a.suppress_tokens == "-1" and a.condition_on_previous_text is True


def test_bridge_loads_the_text_decoder_strictly():
    """JAX's WhisperTextDecoder tree (its top-level positional_embedding
    leaf included) and load_whisper's decoder tree both fill every
    parameter; a missing leaf raises."""
    jdims = JaxDims(*dataclasses.astuple(DIMS))
    params = jax.device_get(fast_random_params(
        lambda: JaxTextDecoder(jdims).init(jax.random.PRNGKey(1), jnp.zeros((1, 3), jnp.int32),
                                           jnp.zeros((1, 1500, 64))), seed=2)["params"])
    dec = load_jax_params(WhisperTextDecoder(DIMS), params)
    np.testing.assert_array_equal(dec.positional_embedding.detach().numpy(), params["positional_embedding"])
    np.testing.assert_array_equal(dec.token_embedding.weight.detach().numpy(),
                                  params["token_embedding"]["embedding"])
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(WhisperTextDecoder(DIMS), {k: v for k, v in params.items() if k != "positional_embedding"})


def test_load_whisper_decoder_tree_equals_jax(whisper_file):
    dims, params = load_whisper(whisper_file)
    jdims, jparams = jax_load_whisper(whisper_file)
    assert dims == jdims == dataclasses.asdict(DIMS)
    dec = load_jax_params(WhisperTextDecoder(DIMS), params["decoder"])
    ref = load_jax_params(WhisperTextDecoder(DIMS), jparams["decoder"])
    for (name, p), q in zip(dec.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name


def test_file_decoder_logits_match_jax(whisper_file):
    """From the fp16 file, the audio features and the decoder's logits on a
    forced token sequence are within 2e-4 of the JAX package's: the
    embeddings' sum is taken at the file's fp16, as JAX's nn.Embed takes it."""
    jdec = jax_transcribe.load_decoder(whisper_file, False)
    pdec = transcribe.load_decoder(whisper_file, False, "cpu")
    assert pdec.decoder.embedding_dtypes == (torch.float16, torch.float16)
    mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(np.float32)
    feats = jdec.embed_audio(jnp.asarray(mel))
    np.testing.assert_allclose(pdec.embed_audio(mel).numpy(), np.asarray(feats), rtol=1e-4, atol=1e-4)
    tokens = np.asarray([[50258, 50259, 50359, 50364, 400, 500, 50400]], np.int32)
    want, _ = jdec.decoder.apply({"params": jdec.decoder_params}, jnp.asarray(tokens), feats)
    with torch.no_grad():
        got, _ = pdec.decoder(torch.from_numpy(tokens).long(), torch.from_numpy(np.array(feats)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("clip", ["tone_3s", "noise_2s"])
def test_cli_transcripts_byte_equal_jax(whisper_file, tmp_path, clip):
    """Both CLIs on the same file and WAV, with no sampled fallback
    (--logprob_threshold=-inf --compression_ratio_threshold inf): beam 5 at
    temperature 0, timestamps on; the .txt/.vtt/.srt must be byte-equal and
    hold at least one segment."""
    rng = np.random.default_rng(4)
    if clip == "tone_3s":
        audio = 0.4 * np.sin(2 * np.pi * 220 * np.arange(3 * 24000) / 24000)
    else:
        audio = 0.2 * rng.standard_normal(2 * 16000)
    wav = str(tmp_path / f"{clip}.wav")
    write_wav(wav, audio, 24000 if clip == "tone_3s" else 16000)
    flags = ["--model", whisper_file, "--logprob_threshold=-inf", "--compression_ratio_threshold", "inf"]
    built = {}
    assert transcribe.main([wav, *flags, "--device", "cpu", "-o", str(tmp_path / "port")], built=built) == 0
    assert jax_transcribe.main([wav, *flags, "--cpu", "-o", str(tmp_path / "jax")]) == 0
    assert built["decoder"].device.type == "cpu" and built["decoder"].primes > 0
    for ext in ("txt", "vtt", "srt"):
        got = (tmp_path / "port" / f"{clip}.wav.{ext}").read_bytes()
        want = (tmp_path / "jax" / f"{clip}.wav.{ext}").read_bytes()
        assert got == want, ext
    assert (tmp_path / "jax" / f"{clip}.wav.vtt").read_bytes().startswith(b"WEBVTT")
    assert (tmp_path / "jax" / f"{clip}.wav.srt").read_bytes().startswith(b"1\n")


def test_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    """--device cuda (the default) where no GPU is available raises; nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcribe.main([str(tmp_path / "x.wav"), "--random-weights", "--device", "cuda"])
