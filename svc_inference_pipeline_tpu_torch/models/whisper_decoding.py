"""Whisper decoding: tokenizer, logit filters, incremental decoding,
language detection and sliding-window transcription.

Counterpart of ``svc_inference_pipeline_tpu/models/whisper_decoding.py``:

* :func:`get_tokenizer`: a byte-level GPT-2 BPE in plain Python that reads
  the repo's vocab files (``svc_inference_pipeline_tpu/assets/{gpt2,
  multilingual}``, data files) in place, with GPT-2's pre-tokenizer pattern
  written for ``re`` from ``unicodedata`` categories, and the Whisper
  special-token layout and non-speech suppress set on top;
* the logit filters :class:`SuppressBlank`, :class:`SuppressTokens` and
  :class:`ApplyTimestampRules`, host-side over [B, vocab] numpy logits;
* :class:`IncrementalDecoder`: one decoder call per token over fixed-size
  per-layer self-KV buffers, the cross-attention (k, v) computed once per
  decode, beam reordering as ``index_select`` along the batch;
* :class:`WhisperDecoder`: greedy, beam (with patience) and temperature
  decoding, language detection, and :meth:`WhisperDecoder.transcribe`, 30 s
  windows with timestamp segmentation, the temperature-fallback ladder,
  no-speech skipping and previous-text conditioning (a window whose last
  timestamp pair sits at ``<|0.00|>`` moves on by the whole window, where
  the JAX copy decodes it again without end);
* :func:`format_timestamp` and the txt/vtt/srt writers.

Each step's [B, vocab] logits come to the host, where the filters and the
token choice run in numpy, as in the JAX package. Sampling draws its
Gumbel noise from a ``torch.Generator`` seeded 0 per decode, or from a
caller's ``noise`` source.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import unicodedata
from functools import lru_cache
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from svc_inference_pipeline_tpu_torch.models.whisper import (
    WHISPER_SIZES,
    WhisperAudioEncoder,
    WhisperDims,
    WhisperTextDecoder,
)
from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

# the tokenizer's vocab files and the spelling table are the JAX package's
# data files, read in place
ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "svc_inference_pipeline_tpu",
    "assets",
)

CHUNK_LENGTH = 30  # seconds per window
TIME_PRECISION = 0.02  # seconds per timestamp token step (30 s / 1500 positions)

# Whisper's 99 language codes in token order (public model card ordering).
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()

# [B, n_vocab] float32 Gumbel draws, one per sampled step of one decode
NoiseSource = Callable[[], Iterator[np.ndarray]]


# ---------------------------------------------------------------------------
# Byte-level BPE
# ---------------------------------------------------------------------------


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# White_Space, which the GPT-2 pattern's \s means
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
                (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
                (0x3000, 0x3000))


def _class(ranges) -> str:
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges)


def _ranges(codes: List[int]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for c in codes:
        if out and out[-1][1] == c - 1:
            out[-1] = (out[-1][0], c)
        else:
            out.append((c, c))
    return out


@lru_cache(maxsize=1)
def gpt2_pattern() -> "re.Pattern":
    """GPT-2's pre-tokenizer, ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, for ``re``: \\p{L} and \\p{N} are
    the Unicode general categories L* and N*, \\s the White_Space
    property."""
    letters, numbers = [], []
    for c in range(0x110000):
        kind = unicodedata.category(chr(c))[0]
        if kind == "L":
            letters.append(c)
        elif kind == "N":
            numbers.append(c)
    lc, nc, sc = _class(_ranges(letters)), _class(_ranges(numbers)), _class(_WHITE_SPACE)
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{lc}]+| ?[{nc}]+| ?[^{sc}{lc}{nc}]+|[{sc}]+(?![^{sc}])|[{sc}]+"
    )


class ByteLevelBPE:
    """GPT-2's byte-level BPE over a ``vocab.json``/``merges.txt`` pair, read
    as ``transformers``' GPT2Tokenizer reads them, with
    ``<|endoftext|>`` as a special token (from the vocab, or from
    ``added_tokens.json`` beside it). ``len`` counts the special token."""

    SPECIAL = "<|endoftext|>"

    def __init__(self, vocab_file: str, merges_file: str, added_tokens_file: Optional[str] = None):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        # the first line is taken for a "#version" header and skipped, as
        # GPT2Tokenizer reads merges files: the multilingual file has no
        # header, so its first merge ("Ġ t") is never applied
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")[1:-1]
        merges = [tuple(line.split()) for line in lines]
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.specials: Dict[str, int] = {}
        if self.SPECIAL in self.encoder:
            self.specials[self.SPECIAL] = self.encoder[self.SPECIAL]
        elif added_tokens_file and os.path.exists(added_tokens_file):
            with open(added_tokens_file, encoding="utf-8") as f:
                self.specials.update(json.load(f))
        else:
            self.specials[self.SPECIAL] = len(self.encoder)
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.decoder.update({i: t for t, i in self.specials.items()})
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._split = re.compile("(" + "|".join(re.escape(t) for t in self.specials) + ")")
        self._cache: Dict[str, List[str]] = {}

    def __len__(self) -> int:
        return len(set(self.encoder.values()) | set(self.specials.values()))

    def token_to_id(self, token: str) -> int:
        return self.specials[token] if token in self.specials else self.encoder[token]

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pair = min(zip(word, word[1:]), key=lambda p: self.ranks.get(p, float("inf")))
            if pair not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == pair:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in self._split.split(text):
            if part in self.specials:
                ids.append(self.specials[part])
                continue
            for piece in gpt2_pattern().findall(part):
                mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """UTF-8 of the tokens' bytes, invalid sequences replaced (a special
        token's text is printable ASCII, its own bytes)."""
        text = "".join(self.decoder[int(i)] for i in ids)
        return bytes(self.byte_decoder[c] for c in text).decode("utf-8", errors="replace")


class WhisperTokenizer:
    """GPT-2 BPE + Whisper special tokens: ``<|endoftext|>``, then in id
    order sot, <lang> x 99 (multilingual only), translate, transcribe,
    startoflm, startofprev, nospeech, notimestamps, <|0.00|>..."""

    def __init__(self, bpe: ByteLevelBPE, multilingual: bool):
        self.tokenizer = bpe
        self.multilingual = multilingual
        self.eot = bpe.token_to_id(ByteLevelBPE.SPECIAL)
        self.sot = self.eot + 1
        n_lang = len(LANGUAGES) if multilingual else 0
        self.language_tokens = tuple(self.sot + 1 + i for i in range(n_lang))
        self.translate = self.sot + 1 + n_lang
        self.transcribe_token = self.translate + 1
        self.sot_lm = self.transcribe_token + 1
        self.sot_prev = self.transcribe_token + 2
        self.no_speech = self.transcribe_token + 3
        self.no_timestamps = self.no_speech + 1
        self.timestamp_begin = self.no_timestamps + 1

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text)

    def decode(self, tokens: Sequence[int]) -> str:
        return self.tokenizer.decode([t for t in tokens if t < self.eot])

    def decode_with_timestamps(self, tokens: Sequence[int]) -> str:
        """Timestamp tokens rendered as ``<|1.08|>``."""
        parts: List[str] = []
        run: List[int] = []
        for t in tokens:
            if t >= self.timestamp_begin:
                if run:
                    parts.append(self.decode(run))
                    run = []
                parts.append(f"<|{(t - self.timestamp_begin) * TIME_PRECISION:.2f}|>")
            else:
                run.append(t)
        if run:
            parts.append(self.decode(run))
        return "".join(parts)

    def sot_sequence(self, language: str = "en", task: str = "transcribe") -> List[int]:
        if not self.multilingual:
            return [self.sot]
        lang_id = self.sot + 1 + LANGUAGES.index(language)
        task_id = self.transcribe_token if task == "transcribe" else self.translate
        return [self.sot, lang_id, task_id]

    @property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids suppressed to keep generations to actual speech: every
        single-token encoding of the annotation symbols (bare and
        space-prefixed), the first token of the U+2640-U+267F music symbols,
        and word-initial ``-`` / ``'``."""
        if getattr(self, "_non_speech", None) is not None:
            return self._non_speech
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        music = set("♩♪♫♬♭♮♯")  # multi-byte; first BPE token shared, safe to cut

        ids = {self.encode(" -")[0], self.encode(" '")[0]}
        for sym in symbols + sorted(music):
            for toks in (self.encode(sym), self.encode(" " + sym)):
                if len(toks) == 1 or sym in music:
                    ids.add(toks[0])
        self._non_speech = tuple(sorted(ids))
        return self._non_speech


@lru_cache(maxsize=2)
def get_tokenizer(multilingual: bool = True, assets_dir: str = ASSETS_DIR) -> WhisperTokenizer:
    """The tokenizer from the vocab files of ``assets_dir``."""
    path = os.path.join(assets_dir, "multilingual" if multilingual else "gpt2")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"tokenizer assets not found at {path}")
    bpe = ByteLevelBPE(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"),
                       os.path.join(path, "added_tokens.json"))
    return WhisperTokenizer(bpe, multilingual)


# ---------------------------------------------------------------------------
# Options / results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodingOptions:
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0


@dataclasses.dataclass
class DecodingResult:
    tokens: List[int]
    text: str
    language: str
    avg_logprob: float
    no_speech_prob: float = 0.0
    temperature: float = 0.0
    compression_ratio: float = 0.0


# ---------------------------------------------------------------------------
# Logit filters (host-side, in place on numpy [B, vocab] logits)
# ---------------------------------------------------------------------------


class LogitFilter:
    def apply(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        raise NotImplementedError


def _log_softmax_np(x: np.ndarray) -> np.ndarray:
    """Row-wise stable log-softmax on host float32 numpy."""
    x = x.astype(np.float32, copy=False)
    m = x.max(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.log(np.sum(np.exp(x - m), axis=-1, keepdims=True))
    return x - m - z


def _softmax_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


class SuppressBlank(LogitFilter):
    """Never start the sample with a blank or EOT."""

    def __init__(self, tokenizer: WhisperTokenizer, sample_begin: int):
        self.ids = tokenizer.encode(" ") + [tokenizer.eot]
        self.sample_begin = sample_begin

    def apply(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        if tokens.shape[1] == self.sample_begin:
            logits[:, self.ids] = -np.inf


class SuppressTokens(LogitFilter):
    def __init__(self, suppress: Sequence[int]):
        self.ids = list(suppress)

    def apply(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        logits[:, self.ids] = -np.inf


class ApplyTimestampRules(LogitFilter):
    """Timestamp grammar: timestamps appear in pairs (except right before
    EOT), the sample opens with a timestamp (bounded by
    ``max_initial_timestamp``), and when the total timestamp probability
    beats every text token the sample is forced to a timestamp."""

    def __init__(self, tokenizer: WhisperTokenizer, sample_begin: int,
                 max_initial_timestamp_index: Optional[int]):
        self.tokenizer = tokenizer
        self.sample_begin = sample_begin
        self.max_initial_timestamp_index = max_initial_timestamp_index

    def apply(self, logits: np.ndarray, tokens: np.ndarray) -> None:
        tok = self.tokenizer
        logits[:, tok.no_timestamps] = -np.inf  # handled by without_timestamps

        for k in range(tokens.shape[0]):
            seq = tokens[k, self.sample_begin:]
            last_ts = seq.size >= 1 and seq[-1] >= tok.timestamp_begin
            penult_ts = seq.size < 2 or seq[-2] >= tok.timestamp_begin
            if last_ts:
                if penult_ts:  # pair complete: next must be non-timestamp
                    logits[k, tok.timestamp_begin:] = -np.inf
                else:  # close the pair: no text allowed
                    logits[k, : tok.eot] = -np.inf

        if tokens.shape[1] == self.sample_begin:
            logits[:, : tok.timestamp_begin] = -np.inf
            if self.max_initial_timestamp_index is not None:
                last_allowed = tok.timestamp_begin + self.max_initial_timestamp_index
                logits[:, last_allowed + 1:] = -np.inf

        # if the timestamp mass beats every single text token, force a timestamp
        lp = _log_softmax_np(logits)
        ts = lp[:, tok.timestamp_begin:]
        m = ts.max(axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ts_mass = np.where(
                np.isfinite(m),
                np.log(np.exp(ts - m[:, None]).sum(axis=-1)) + m,
                -np.inf,
            )
        max_text = lp[:, : tok.timestamp_begin].max(axis=-1)
        logits[ts_mass > max_text, : tok.timestamp_begin] = -np.inf


def build_suppress_tokens(
    tokenizer: WhisperTokenizer,
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1",
) -> Tuple[int, ...]:
    """``"-1"`` expands to the non-speech set; SOT/SOT_PREV/SOT_LM and
    ``<|nospeech|>`` are always suppressed."""
    if isinstance(suppress_tokens, str):
        suppress = [int(t) for t in suppress_tokens.split(",") if t]
    else:
        suppress = list(suppress_tokens or [])

    if -1 in suppress:
        suppress = [t for t in suppress if t >= 0]
        suppress.extend(tokenizer.non_speech_tokens)

    suppress.extend([tokenizer.sot, tokenizer.sot_prev, tokenizer.sot_lm])
    suppress.append(tokenizer.no_speech)  # collected separately as a prob
    return tuple(sorted(set(suppress)))


# ---------------------------------------------------------------------------
# Incremental decoding
# ---------------------------------------------------------------------------


class IncrementalDecoder:
    """One decoder call per token over fixed-size self-KV buffers: a
    [B, n_text_ctx, n_text_state] pair per layer, written in place at the
    current offset; attention reads the rows written so far. The prime
    computes the cross-attention (k, v) of every layer once."""

    def __init__(self, dims: WhisperDims, decoder: WhisperTextDecoder):
        self.dims = dims
        self.decoder = decoder

    def _empty_cache(self, b: int, device) -> Dict[str, tuple]:
        d = self.dims
        z = lambda: torch.zeros((b, d.n_text_ctx, d.n_text_state), device=device)  # noqa: E731
        return {f"self_{i}": (z(), z()) for i in range(d.n_text_layer)}

    @torch.no_grad()
    def prime(self, tokens: np.ndarray, audio_features: torch.Tensor) -> Tuple[np.ndarray, dict, int]:
        """Run the prefix once. Returns (logits [B, T0, V], cache, offset)."""
        b, t0 = tokens.shape
        dev = audio_features.device
        logits, cache = self.decoder(torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev),
                                     audio_features, cache=self._empty_cache(b, dev), offset=0)
        return logits.cpu().numpy(), cache, t0

    @torch.no_grad()
    def step(self, token: np.ndarray, audio_features: torch.Tensor, cache: dict, offset: int):
        """One token for every batch row. Returns (logits [B, V], cache)."""
        tokens = torch.as_tensor(np.asarray(token), dtype=torch.long, device=audio_features.device)
        logits, cache = self.decoder(tokens, audio_features, cache=cache, offset=offset)
        return logits[:, -1].cpu().numpy(), cache

    def reorder(self, cache: dict, source_indices: Sequence[int]) -> dict:
        """Gather the cache along batch (beam-search parent selection)."""
        device = next(iter(cache.values()))[0].device
        idx = torch.as_tensor(np.asarray(source_indices, np.int64), device=device)
        return {key: tuple(t.index_select(0, idx) for t in pair) for key, pair in cache.items()}


# ---------------------------------------------------------------------------
# Decoder facade
# ---------------------------------------------------------------------------


def _compression_ratio(text: str) -> float:
    import zlib

    data = text.encode("utf-8")
    return len(data) / max(len(zlib.compress(data)), 1)


def _seeded_gumbel(shape: Tuple[int, int], seed: int = 0) -> Iterator[np.ndarray]:
    """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1), from a
    CPU ``torch.Generator`` seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    tiny = torch.finfo(torch.float32).tiny
    while True:
        u = torch.rand(shape, generator=g, dtype=torch.float32).clamp_(min=tiny)
        yield (-torch.log(-torch.log(u))).numpy()


class WhisperDecoder:
    """Encoder + text decoder on one device. On a GPU the encoder's matmul
    weights are bf16 (K4 takes bf16) with the LayerNorms f32, as
    ``WhisperPPGExtractor`` holds them; on the CPU it is f32. The text
    decoder is f32 on both.

    ``step_log`` collects (host seconds, decoder-call seconds) for each token
    position decoded: the filters and token choice on the host, then the
    incremental step with its logits' copy to the host (0 where the loop
    ends at that position); ``primes`` counts the prefix calls and
    ``windows`` the 30 s windows that ``transcribe`` encoded."""

    def __init__(self, encoder: WhisperAudioEncoder, decoder: WhisperTextDecoder):
        self.dims = decoder.dims
        self.encoder = encoder
        self.decoder = decoder
        self.device = decoder.token_embedding.weight.device
        self.incremental = IncrementalDecoder(self.dims, decoder)
        self.step_log: List[Tuple[float, float]] = []
        self.primes = 0
        self.windows = 0

    @classmethod
    def _placed(cls, encoder: WhisperAudioEncoder, decoder: WhisperTextDecoder, device) -> "WhisperDecoder":
        from svc_inference_pipeline_tpu_torch.pipeline.content import cast_matmul_weights_

        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        encoder = cast_matmul_weights_(encoder.to(device).eval(), dtype)
        return cls(encoder, decoder.to(device).eval())

    @classmethod
    def from_jax_params(cls, dims: WhisperDims, encoder_params, decoder_params, device=None) -> "WhisperDecoder":
        """JAX parameter trees (numpy) on ``device`` (None: the GPU)."""
        from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, unstack_blocks

        device = resolve_device(device)
        with torch.device(device):
            enc, dec = WhisperAudioEncoder(dims), WhisperTextDecoder(dims)
        load_jax_params(enc, unstack_blocks(encoder_params, dims.n_audio_layer))
        load_jax_params(dec, decoder_params)
        dec.embedding_dtypes = tuple(
            getattr(torch, np.asarray(x).dtype.name)
            for x in (decoder_params["token_embedding"]["embedding"], decoder_params["positional_embedding"]))
        return cls._placed(enc, dec, device)

    @classmethod
    def from_torch_checkpoint(cls, path: str, device=None) -> "WhisperDecoder":
        """A Whisper ``.pt`` file (``{"dims", "model_state_dict"}``)."""
        from svc_inference_pipeline_tpu_torch.checkpoints.torch_convert import load_whisper

        dims_dict, params = load_whisper(path)
        return cls.from_jax_params(WhisperDims(**dims_dict), params["encoder"], params["decoder"], device)

    @classmethod
    def random_init(cls, size_or_dims: Union[str, WhisperDims] = "tiny", seed: int = 0,
                    device=None) -> "WhisperDecoder":
        """Random weights (the JAX smoke-run scheme, ``random_init_``) drawn on
        ``device`` from one generator seeded ``seed``: encoder, then decoder."""
        from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import random_init_

        device = resolve_device(device)
        dims = WHISPER_SIZES[size_or_dims] if isinstance(size_or_dims, str) else size_or_dims
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.device(device):
            enc, dec = WhisperAudioEncoder(dims), WhisperTextDecoder(dims)
        random_init_(enc, g)
        random_init_(dec, g)
        return cls._placed(enc, dec, device)

    @torch.no_grad()
    def embed_audio(self, mel) -> torch.Tensor:
        """[B, n_mels, 3000] log-mel -> [B, n_audio_ctx, D] f32 features."""
        return self.encoder(torch.as_tensor(mel, dtype=torch.float32, device=self.device))

    def _prime(self, tokens: np.ndarray, audio_features):
        self.primes += 1
        return self.incremental.prime(tokens, audio_features)

    # -- language id ---------------------------------------------------

    def detect_language(self, audio_features, tokenizer: WhisperTokenizer) -> Tuple[str, dict]:
        """P(language | audio) from one decoder step at SOT."""
        b = audio_features.shape[0]
        tokens = np.full((b, 1), tokenizer.sot, dtype=np.int32)
        logits, _, _ = self._prime(tokens, audio_features)
        logits = logits[:, -1]
        mask = np.full(logits.shape[-1], -np.inf)
        mask[list(tokenizer.language_tokens)] = 0.0
        probs = _softmax_np(logits + mask)[0]
        lang_probs = {
            lang: float(probs[tok])
            for lang, tok in zip(LANGUAGES, tokenizer.language_tokens)
        }
        best = max(lang_probs, key=lang_probs.get)
        return best, lang_probs

    # -- shared decode machinery ----------------------------------------

    def _initial_tokens(self, tokenizer: WhisperTokenizer, options: DecodingOptions,
                        sample_len: int) -> List[int]:
        """SOT sequence with prefix/prompt handling."""
        language = options.language or "en"
        tokens = tokenizer.sot_sequence(language, options.task)
        if options.without_timestamps:
            tokens = tokens + [tokenizer.no_timestamps]

        if options.prefix is not None:
            prefix = (
                tokenizer.encode(" " + options.prefix.strip())
                if isinstance(options.prefix, str)
                else list(options.prefix)
            )
            max_prefix = self.dims.n_text_ctx // 2 - sample_len
            tokens = tokens + prefix[-max_prefix:] if max_prefix > 0 else tokens
        if options.prompt is not None and len(options.prompt) > 0:
            prompt = (
                tokenizer.encode(" " + options.prompt.strip())
                if isinstance(options.prompt, str)
                else list(options.prompt)
            )
            tokens = (
                [tokenizer.sot_prev]
                + prompt[-(self.dims.n_text_ctx // 2 - 1):]
                + tokens
            )
        return tokens

    def _build_filters(self, tokenizer: WhisperTokenizer, options: DecodingOptions,
                       sample_begin: int) -> List[LogitFilter]:
        filters: List[LogitFilter] = []
        if options.suppress_blank:
            filters.append(SuppressBlank(tokenizer, sample_begin))
        if options.suppress_tokens:
            filters.append(SuppressTokens(build_suppress_tokens(tokenizer, options.suppress_tokens)))
        if not options.without_timestamps:
            max_initial_index = None
            if options.max_initial_timestamp is not None:
                max_initial_index = round(options.max_initial_timestamp / TIME_PRECISION)
            filters.append(ApplyTimestampRules(tokenizer, sample_begin, max_initial_index))
        return filters

    def decode(self, audio_features, tokenizer: WhisperTokenizer,
               options: DecodingOptions = DecodingOptions(),
               noise: Optional[NoiseSource] = None) -> DecodingResult:
        """Greedy at temperature 0, categorical sampling otherwise (Gumbel
        draws from ``noise``, default a generator seeded 0), beam search
        when ``beam_size`` is set."""
        if options.beam_size is not None:
            return self._beam_loop(audio_features, tokenizer, options)
        return self._sample_loop(audio_features, tokenizer, options, noise=noise)

    def _sample_loop(self, audio_features, tokenizer: WhisperTokenizer, options: DecodingOptions,
                     noise: Optional[NoiseSource] = None) -> DecodingResult:
        temperature = options.temperature
        language = options.language or "en"
        sample_len = options.sample_len or self.dims.n_text_ctx // 2
        initial = self._initial_tokens(tokenizer, options, sample_len)
        sample_begin = len(initial)
        sot_index = initial.index(tokenizer.sot)
        filters = self._build_filters(tokenizer, options, sample_begin)

        b = audio_features.shape[0]
        tokens = np.tile(np.asarray(initial, np.int32)[None], (b, 1))
        prime_logits, cache, offset = self._prime(tokens, audio_features)
        draws = None
        if temperature > 0:
            draws = noise() if noise is not None else _seeded_gumbel((b, prime_logits.shape[-1]))

        # no-speech probability read at the SOT position
        no_speech_prob = float(_softmax_np(prime_logits[:, sot_index])[0, tokenizer.no_speech])

        step_logits = prime_logits[:, -1].copy()
        sum_logprobs = np.zeros(b)
        finished = np.zeros(b, dtype=bool)

        for _ in range(sample_len):
            t0 = time.perf_counter()
            for f in filters:
                f.apply(step_logits, tokens)
            logprobs = _log_softmax_np(step_logits)
            if temperature <= 0:
                next_tok = step_logits.argmax(axis=-1).astype(np.int32)
            else:
                # logits / T rounded to f32, then the f32 draw added: what
                # jax.random.categorical computes on the same draw
                scaled = np.asarray(step_logits / temperature, np.float32)
                next_tok = (scaled + next(draws)).argmax(axis=-1).astype(np.int32)
            next_tok = np.where(finished, tokenizer.eot, next_tok)
            sum_logprobs += np.where(finished, 0.0, logprobs[np.arange(b), next_tok])
            finished |= next_tok == tokenizer.eot
            tokens = np.concatenate([tokens, next_tok[:, None]], axis=1)
            t1 = time.perf_counter()
            if finished.all() or tokens.shape[1] > self.dims.n_text_ctx - 1:
                self.step_log.append((t1 - t0, 0.0))
                break
            step_logits, cache = self.incremental.step(next_tok[:, None], audio_features, cache, offset)
            step_logits = step_logits.copy()
            offset += 1
            self.step_log.append((t1 - t0, time.perf_counter() - t1))

        seq = tokens[0, sample_begin:].tolist()
        if tokenizer.eot in seq:
            seq = seq[: seq.index(tokenizer.eot)]
        text = tokenizer.decode(seq).strip()
        return DecodingResult(
            tokens=seq,
            text=text,
            language=language,
            avg_logprob=float(sum_logprobs[0]) / (len(seq) + 1),
            no_speech_prob=no_speech_prob,
            temperature=temperature,
            compression_ratio=_compression_ratio(text),
        )

    def _beam_loop(self, audio_features, tokenizer: WhisperTokenizer,
                   options: DecodingOptions) -> DecodingResult:
        """Beam search with patience: expand until ``beam_size x patience``
        hypotheses finish; rank by length-normalised sum-logprob. The KV cache
        holds beam_size rows, reordered by parent each step."""
        beam_size = options.beam_size or 5
        patience = options.patience or 1.0
        max_finished = round(beam_size * patience)
        language = options.language or "en"
        sample_len = options.sample_len or self.dims.n_text_ctx // 2
        initial = self._initial_tokens(tokenizer, options, sample_len)
        sample_begin = len(initial)
        sot_index = initial.index(tokenizer.sot)
        filters = self._build_filters(tokenizer, options, sample_begin)

        feats = audio_features[:1].repeat(beam_size, 1, 1)
        tokens = np.tile(np.asarray(initial, np.int32)[None], (beam_size, 1))
        prime_logits, cache, offset = self._prime(tokens, feats)
        no_speech_prob = float(_softmax_np(prime_logits[:, sot_index])[0, tokenizer.no_speech])

        step_logits = prime_logits[:, -1].copy()
        sum_logprobs = np.zeros(beam_size)
        sum_logprobs[1:] = -np.inf  # identical initial beams: keep only one
        finished: List[Tuple[float, List[int]]] = []

        for _ in range(sample_len):
            t0 = time.perf_counter()
            for f in filters:
                f.apply(step_logits, tokens)
            logprobs = _log_softmax_np(step_logits)
            # candidate pool: top (beam_size+1) continuations per live beam
            candidates = []  # (score, parent, token)
            for i in range(beam_size):
                if not np.isfinite(sum_logprobs[i]):
                    continue
                top = np.argsort(logprobs[i])[::-1][: beam_size + 1]
                for t in top:
                    candidates.append((sum_logprobs[i] + float(logprobs[i, t]), i, int(t)))
            candidates.sort(key=lambda c: c[0], reverse=True)

            next_rows: List[Tuple[float, int, int]] = []
            for score, parent, t in candidates:
                if t == tokenizer.eot:
                    finished.append((score, tokens[parent, sample_begin:].tolist()))
                    if len(finished) >= max_finished:
                        break
                else:
                    next_rows.append((score, parent, t))
                if len(next_rows) >= beam_size:
                    break
            if len(finished) >= max_finished or not next_rows:
                self.step_log.append((time.perf_counter() - t0, 0.0))
                break

            # pad dead rows by repeating row 0 with -inf score
            while len(next_rows) < beam_size:
                next_rows.append((-np.inf, next_rows[0][1], next_rows[0][2]))

            parents = [r[1] for r in next_rows]
            new_toks = np.asarray([r[2] for r in next_rows], np.int32)
            sum_logprobs = np.asarray([r[0] for r in next_rows])
            tokens = np.concatenate([tokens[parents], new_toks[:, None]], axis=1)
            t1 = time.perf_counter()
            if tokens.shape[1] > self.dims.n_text_ctx - 1:
                self.step_log.append((t1 - t0, 0.0))
                break
            cache = self.incremental.reorder(cache, parents)
            step_logits, cache = self.incremental.step(new_toks[:, None], feats, cache, offset)
            step_logits = step_logits.copy()
            offset += 1
            self.step_log.append((t1 - t0, time.perf_counter() - t1))

        if not finished:
            best_i = int(np.argmax(sum_logprobs))
            finished = [(float(sum_logprobs[best_i]), tokens[best_i, sample_begin:].tolist())]

        # maximum likelihood ranking: score / length penalty
        def rank(item):
            score, toks = item
            n = len(toks) + 1
            if options.length_penalty is None:
                return score / n
            return score / (((5 + n) / 6) ** options.length_penalty)

        score, seq = max(finished, key=rank)
        if tokenizer.eot in seq:
            seq = seq[: seq.index(tokenizer.eot)]
        text = tokenizer.decode(seq).strip()
        return DecodingResult(
            tokens=seq,
            text=text,
            language=language,
            avg_logprob=score / (len(seq) + 1),
            no_speech_prob=no_speech_prob,
            temperature=0.0,
            compression_ratio=_compression_ratio(text),
        )

    # -- named decoding modes --------------------------------------------

    def greedy_decode(self, audio_features, tokenizer,
                      options: DecodingOptions = DecodingOptions()) -> DecodingResult:
        return self._sample_loop(audio_features, tokenizer, dataclasses.replace(options, temperature=0.0))

    def beam_decode(self, audio_features, tokenizer, options: DecodingOptions = DecodingOptions(),
                    beam_size: int = 5, patience: float = 1.0) -> DecodingResult:
        return self._beam_loop(audio_features, tokenizer,
                               dataclasses.replace(options, beam_size=beam_size, patience=patience))

    def sample_decode(self, audio_features, tokenizer, options: DecodingOptions = DecodingOptions(),
                      temperature: float = 0.0, noise: Optional[NoiseSource] = None) -> DecodingResult:
        return self._sample_loop(audio_features, tokenizer,
                                 dataclasses.replace(options, temperature=temperature), noise=noise)

    # -- transcription ----------------------------------------------------

    def transcribe(
        self,
        audio_16k: np.ndarray,
        tokenizer: WhisperTokenizer,
        options: DecodingOptions = DecodingOptions(),
        temperatures: tuple = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        verbose: Optional[bool] = None,
        noise: Optional[NoiseSource] = None,
    ) -> dict:
        """Sliding-window transcription: temperature fallback on degenerate
        decodes, no-speech skipping, timestamp segmentation with
        seek-by-last-timestamp, and previous-text prompt conditioning.
        ``noise`` is called once per sampled decode."""
        from svc_inference_pipeline_tpu_torch.ops.whisper_mel import (
            HOP_LENGTH,
            N_FRAMES,
            log_mel_spectrogram_frames,
        )

        mel = log_mel_spectrogram_frames(np.asarray(audio_16k, np.float32), self.device)  # [80, T]
        num_frames = mel.shape[-1]
        input_stride = N_FRAMES // self.dims.n_audio_ctx  # 2 frames per position
        frame_time = HOP_LENGTH / 16000.0

        all_tokens: List[int] = []
        all_segments: List[dict] = []
        prompt_reset_since = 0
        if initial_prompt is not None:
            all_tokens.extend(tokenizer.encode(" " + initial_prompt.strip()))

        def decode_with_fallback(feats) -> DecodingResult:
            result = None
            for t in temperatures:
                opts = dataclasses.replace(options, temperature=t)
                if t > 0:  # best_of applies to sampling, beams to greedy
                    opts = dataclasses.replace(opts, beam_size=None, patience=None)
                result = self.decode(feats, tokenizer, opts, noise=noise)
                needs_fallback = False
                if (
                    compression_ratio_threshold is not None
                    and result.compression_ratio > compression_ratio_threshold
                ):
                    needs_fallback = True
                if (
                    logprob_threshold is not None
                    and result.avg_logprob < logprob_threshold
                ):
                    needs_fallback = True
                if not needs_fallback:
                    break
            return result

        def add_segment(start, end, text_tokens, result):
            text = tokenizer.decode([t for t in text_tokens if t < tokenizer.eot])
            if not text.strip():
                return
            all_segments.append(
                dict(
                    id=len(all_segments),
                    seek=seek,
                    start=start,
                    end=end,
                    text=text,
                    tokens=list(text_tokens),
                    temperature=result.temperature,
                    avg_logprob=result.avg_logprob,
                    compression_ratio=result.compression_ratio,
                    no_speech_prob=result.no_speech_prob,
                )
            )
            if verbose:
                print(f"[{format_timestamp(start)} --> {format_timestamp(end)}] {text}")

        seek = 0
        while seek < num_frames:
            timestamp_offset = seek * frame_time
            chunk = mel[:, seek: seek + N_FRAMES]
            segment_frames = min(N_FRAMES, num_frames - seek)
            if chunk.shape[-1] < N_FRAMES:
                chunk = np.pad(chunk, [(0, 0), (0, N_FRAMES - chunk.shape[-1])])
            feats = self.embed_audio(chunk[None])
            self.windows += 1

            if condition_on_previous_text:
                options = dataclasses.replace(options, prompt=all_tokens[prompt_reset_since:])
            result = decode_with_fallback(feats)
            tokens = np.asarray(result.tokens)

            if no_speech_threshold is not None:
                should_skip = result.no_speech_prob > no_speech_threshold
                if (
                    logprob_threshold is not None
                    and result.avg_logprob > logprob_threshold
                ):
                    should_skip = False  # confident text overrides no-speech
                if should_skip:
                    seek += segment_frames
                    continue

            ts_mask = tokens >= tokenizer.timestamp_begin
            consecutive = np.where(ts_mask[:-1] & ts_mask[1:])[0] + 1
            if len(consecutive) > 0:
                # complete <|t0|> text <|t1|> segments; seek to the last pair
                last_slice = 0
                for current_slice in consecutive:
                    sliced = tokens[last_slice:current_slice]
                    start_pos = int(sliced[0]) - tokenizer.timestamp_begin
                    end_pos = int(sliced[-1]) - tokenizer.timestamp_begin
                    add_segment(
                        start=timestamp_offset + start_pos * TIME_PRECISION,
                        end=timestamp_offset + end_pos * TIME_PRECISION,
                        text_tokens=sliced[1:-1].tolist(),
                        result=result,
                    )
                    last_slice = int(current_slice)
                last_pos = int(tokens[last_slice - 1]) - tokenizer.timestamp_begin
                # a last pair at <|0.00|> would leave seek where it was and
                # decode the same window again, without end: take the window
                seek += last_pos * input_stride if last_pos > 0 else segment_frames
                all_tokens.extend(tokens[: last_slice + 1].tolist())
            else:
                duration = segment_frames * frame_time
                ts = tokens[ts_mask]
                if len(ts) > 0 and int(ts[-1]) != tokenizer.timestamp_begin:
                    # lone trailing timestamp: no speech after it
                    duration = (int(ts[-1]) - tokenizer.timestamp_begin) * TIME_PRECISION
                add_segment(
                    start=timestamp_offset,
                    end=timestamp_offset + duration,
                    text_tokens=tokens.tolist(),
                    result=result,
                )
                seek += segment_frames
                all_tokens.extend(tokens.tolist())

            if not condition_on_previous_text or result.temperature > 0.5:
                prompt_reset_since = len(all_tokens)

        n_prompt = len(tokenizer.encode(" " + initial_prompt.strip())) if initial_prompt else 0
        return dict(
            text=tokenizer.decode(all_tokens[n_prompt:]),
            segments=all_segments,
            language=options.language or "en",
        )


# ---------------------------------------------------------------------------
# Transcript writers
# ---------------------------------------------------------------------------


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    assert seconds >= 0
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hh = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hh}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def write_txt(transcript, file) -> None:
    for segment in transcript:
        print(segment["text"].strip(), file=file, flush=True)


def write_vtt(transcript, file) -> None:
    print("WEBVTT\n", file=file)
    for segment in transcript:
        print(
            f"{format_timestamp(segment['start'])} --> {format_timestamp(segment['end'])}\n"
            f"{segment['text'].strip().replace('-->', '->')}\n",
            file=file,
            flush=True,
        )


def write_srt(transcript, file) -> None:
    for i, segment in enumerate(transcript, start=1):
        start = format_timestamp(segment["start"], True, ",")
        end = format_timestamp(segment["end"], True, ",")
        print(
            f"{i}\n{start} --> {end}\n{segment['text'].strip().replace('-->', '->')}\n",
            file=file,
            flush=True,
        )
