"""Text normalizers for comparing transcripts.

Counterpart of ``svc_inference_pipeline_tpu/models/text_normalizers.py`` (a
copy: pure Python, ``re`` and ``unicodedata``):

* :class:`BasicTextNormalizer`: unicode symbol/diacritic removal,
  lowercase, whitespace collapse; ``split_letters`` spaces out the grapheme
  clusters of :func:`graphemes` (the JAX copy calls ``re``'s ``\\X``, which
  stdlib ``re`` does not have, and raises);
* :class:`EnglishNumberNormalizer`: spelled-out to arabic numbers with
  ordinal/plural suffixes, currency symbols, percent, decimals and
  double/triple digit runs, as an explicit-index state machine;
* :class:`EnglishSpellingNormalizer`: British to American spelling from the
  JAX package's ``assets/english_spelling.json`` (a data file, read in
  place);
* :class:`EnglishTextNormalizer`: the full composition: annotation
  removal, filler-word removal, contraction/title expansion, number and
  spelling standardisation, symbol cleanup.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Union

_SPELLING_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "svc_inference_pipeline_tpu",
    "assets",
    "english_spelling.json",
)


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace markers/symbols/punctuation with a space, drop diacritics."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif unicodedata.category(c) == "Mn":
            continue  # combining mark (diacritic)
        elif unicodedata.category(c)[0] in "MSP":
            out.append(" ")
        else:
            out.append(c)
    return "".join(out)


def graphemes(s: str) -> List[str]:
    """Grapheme clusters of ``s``: each character that is not a combining
    mark (categories Mn, Mc, Me) starts a cluster and takes the marks that
    follow it."""
    clusters: List[str] = []
    for c in s:
        if clusters and unicodedata.category(c) in ("Mn", "Mc", "Me"):
            clusters[-1] += c
        else:
            clusters.append(c)
    return clusters


def remove_symbols(s: str) -> str:
    """Replace markers/symbols/punctuation with a space (keep diacritics)."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # bracketed annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)  # parenthesised annotations
        s = self.clean(s).lower()
        if self.split_letters:
            s = " ".join(graphemes(s))
        return re.sub(r"\s+", " ", s).strip()


# ---------------------------------------------------------------------------
# Number normalisation (english.py:12-441 behaviour)
# ---------------------------------------------------------------------------

_ONES_NAMES = (
    "one two three four five six seven eight nine ten eleven twelve thirteen "
    "fourteen fifteen sixteen seventeen eighteen nineteen"
).split()
_TENS_NAMES = "twenty thirty forty fifty sixty seventy eighty ninety".split()
_MULTIPLIER_NAMES = (
    "hundred thousand million billion trillion quadrillion quintillion "
    "sextillion septillion octillion nonillion decillion"
).split()
_MULTIPLIER_VALUES = [100] + [10 ** (3 * (i + 1)) for i in range(len(_MULTIPLIER_NAMES) - 1)]

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


class EnglishNumberNormalizer:
    """Spelled-out → arabic numbers.

    Handles (matching the reference's documented contract):
    digit-comma removal, suffix preservation (``1960s``, ``274th``, ``32nd``),
    currency words to symbols before the amount (``$20 million`` →
    ``20000000 dollars`` → ``$20000000``), ``one``/``ones`` kept literal,
    nominal digit runs (``one oh one`` → ``101``), ``double``/``triple``,
    ``point`` decimals, ``per cent``/``percent`` → ``%``, sign words.
    """

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones: Dict[str, int] = {w: i + 1 for i, w in enumerate(_ONES_NAMES)}
        self.tens: Dict[str, int] = {w: 10 * (i + 2) for i, w in enumerate(_TENS_NAMES)}
        self.multipliers: Dict[str, int] = dict(zip(_MULTIPLIER_NAMES, _MULTIPLIER_VALUES))

        def plural(w: str) -> str:
            return "sixes" if w == "six" else w + "s"

        def ordinal_ones(w: str) -> str:
            return w + ("h" if w.endswith("t") else "th")

        self.ones_suffixed: Dict[str, tuple] = {}
        for w, v in self.ones.items():
            self.ones_suffixed[plural(w)] = (v, "s")
        irregular = {"zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
                     "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th")}
        self.ones_suffixed.update(irregular)
        for w, v in self.ones.items():
            if v > 3 and v not in (5, 12):
                self.ones_suffixed[ordinal_ones(w)] = (v, "th")

        self.tens_suffixed: Dict[str, tuple] = {}
        for w, v in self.tens.items():
            self.tens_suffixed[w[:-1] + "ies"] = (v, "s")
            self.tens_suffixed[w[:-1] + "ieth"] = (v, "th")

        self.multipliers_suffixed: Dict[str, tuple] = {}
        for w, v in self.multipliers.items():
            self.multipliers_suffixed[w + "s"] = (v, "s")
            self.multipliers_suffixed[w + "th"] = (v, "th")

        self.sign_words = {"minus": "-", "negative": "-", "plus": "+", "positive": "+"}
        self.currency_words = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefix_chars = set("+-£€$¢")
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}
        self.decimals = self.zeros | set(self.ones) | set(self.tens)

        self.words = (
            self.zeros | set(self.ones) | set(self.ones_suffixed)
            | set(self.tens) | set(self.tens_suffixed)
            | set(self.multipliers) | set(self.multipliers_suffixed)
            | set(self.sign_words) | set(self.currency_words)
            | set(self.suffixers) | self.specials
        )

    # -- the token state machine ------------------------------------------

    def _walk(self, tokens: List[str]) -> Iterator[str]:
        value: Optional[Union[str, int]] = None  # str ⇒ digit-concatenation mode
        prefix: Optional[str] = None  # pending sign / currency symbol

        def emit(result) -> str:
            nonlocal value, prefix
            text = str(result)
            if prefix is not None:
                text = prefix + text
            value, prefix = None, None
            return text

        i = 0
        n = len(tokens)
        while i < n:
            cur = tokens[i]
            prev = tokens[i - 1] if i > 0 else None
            nxt = tokens[i + 1] if i + 1 < n else None
            nxt_numeric = nxt is not None and _NUMERIC_RE.match(nxt)
            i += 1

            leading_prefix = cur[:1] in self.prefix_chars
            bare = cur[1:] if leading_prefix else cur

            if _NUMERIC_RE.match(bare):
                # already-arabic token, possibly signed/currency-prefixed
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        value = value + cur  # decimal / ip-address continuation
                        continue
                    yield emit(value)
                if leading_prefix:
                    prefix = cur[0]
                as_fraction = Fraction(bare)
                value = as_fraction.numerator if as_fraction.denominator == 1 else bare
                continue

            if cur not in self.words:
                if value is not None:
                    yield emit(value)
                yield emit(cur)
                continue

            if cur in self.zeros:
                value = str(value or "") + "0"

            elif cur in self.ones:
                d = self.ones[cur]
                if value is None:
                    value = d
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and d < 10:
                        # "twenty one": the tens' trailing zero takes the digit
                        value = str(value)[:-1] + str(d)
                    else:
                        value = str(value) + str(d)
                elif d < 10:
                    value = value + d if value % 10 == 0 else str(value) + str(d)
                else:  # eleven…nineteen
                    value = value + d if value % 100 == 0 else str(value) + str(d)

            elif cur in self.ones_suffixed:
                d, suffix = self.ones_suffixed[cur]
                if value is None:
                    yield emit(f"{d}{suffix}")
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and d < 10:
                        yield emit(str(value)[:-1] + f"{d}{suffix}")
                    else:
                        yield emit(f"{value}{d}{suffix}")
                elif d < 10:
                    if value % 10 == 0:
                        yield emit(f"{value + d}{suffix}")
                    else:
                        yield emit(f"{value}{d}{suffix}")
                else:
                    if value % 100 == 0:
                        yield emit(f"{value + d}{suffix}")
                    else:
                        yield emit(f"{value}{d}{suffix}")
                value = None

            elif cur in self.tens:
                t = self.tens[cur]
                if value is None:
                    value = t
                elif isinstance(value, str):
                    value = str(value) + str(t)
                else:
                    value = value + t if value % 100 == 0 else str(value) + str(t)

            elif cur in self.tens_suffixed:
                t, suffix = self.tens_suffixed[cur]
                if value is None:
                    yield emit(f"{t}{suffix}")
                elif isinstance(value, str):
                    yield emit(f"{value}{t}{suffix}")
                elif value % 100 == 0:
                    yield emit(f"{value + t}{suffix}")
                else:
                    yield emit(f"{value}{t}{suffix}")

            elif cur in self.multipliers:
                m = self.multipliers[cur]
                if value is None:
                    value = m
                elif isinstance(value, str) or value == 0:
                    try:
                        scaled = Fraction(value) * m
                    except ValueError:
                        scaled = None
                    if scaled is not None and scaled.denominator == 1:
                        value = scaled.numerator
                    else:
                        yield emit(value)
                        value = m
                else:
                    # "two hundred five thousand": scale the sub-thousand part
                    thousands = value // 1000 * 1000
                    value = thousands + (value % 1000) * m

            elif cur in self.multipliers_suffixed:
                m, suffix = self.multipliers_suffixed[cur]
                if value is None:
                    yield emit(f"{m}{suffix}")
                elif isinstance(value, str):
                    try:
                        scaled = Fraction(value) * m
                    except ValueError:
                        scaled = None
                    if scaled is not None and scaled.denominator == 1:
                        yield emit(f"{scaled.numerator}{suffix}")
                    else:
                        yield emit(value)
                        yield emit(f"{m}{suffix}")
                else:
                    thousands = value // 1000 * 1000
                    yield emit(f"{thousands + (value % 1000) * m}{suffix}")
                value = None

            elif cur in self.sign_words:
                if value is not None:
                    yield emit(value)
                if nxt in self.words or nxt_numeric:
                    prefix = self.sign_words[cur]
                else:
                    yield emit(cur)

            elif cur in self.currency_words:
                # currency applies only AFTER an amount ("twenty dollars")
                if value is not None:
                    prefix = self.currency_words[cur]
                    yield emit(value)
                else:
                    yield emit(cur)

            elif cur in self.suffixers:
                if value is not None:
                    rule = self.suffixers[cur]
                    if isinstance(rule, dict):
                        if nxt in rule:
                            yield emit(f"{value}{rule[nxt]}")
                            i += 1  # consumed the lookahead word
                        else:
                            yield emit(value)
                            yield emit(cur)
                    else:
                        yield emit(f"{value}{rule}")
                else:
                    yield emit(cur)

            elif cur in self.specials:
                if nxt not in self.words and not nxt_numeric:
                    if value is not None:
                        yield emit(value)
                    yield emit(cur)
                elif cur == "and":
                    # "one hundred and five" — drop the glue word
                    if prev not in self.multipliers:
                        if value is not None:
                            yield emit(value)
                        yield emit(cur)
                elif cur in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        reps = 2 if cur == "double" else 3
                        value = str(value or "") + str(self.ones.get(nxt, 0)) * reps
                        i += 1
                    else:
                        if value is not None:
                            yield emit(value)
                        yield emit(cur)
                elif cur == "point":
                    if nxt in self.decimals or nxt_numeric:
                        value = str(value or "") + "."

        if value is not None:
            yield emit(value)

    # -- pre/post passes ---------------------------------------------------

    def _expand_half(self, s: str) -> str:
        """"<number> and a half" → "<number> point five" when it truly
        follows a number word (english.py:382-400)."""
        pieces = re.split(r"\band\s+a\s+half\b", s)
        if len(pieces) == 1:
            return s
        out: List[str] = []
        for i, piece in enumerate(pieces):
            if not piece.strip():
                continue
            out.append(piece)
            if i < len(pieces) - 1:
                tail = piece.rsplit(maxsplit=2)[-1]
                if tail in self.decimals or tail in self.multipliers:
                    out.append("point five")
                else:
                    out.append("and a half")
        return " ".join(out)

    def preprocess(self, s: str) -> str:
        s = self._expand_half(s)
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)  # letter|digit boundary
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)  # re-join suffixes
        return s

    def postprocess(self, s: str) -> str:
        def fuse_cents(m: re.Match) -> str:
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def cents_only(m: re.Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", fuse_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", cents_only, s)
        s = re.sub(r"\b1(s?)\b", r"one\1", s)  # literal "one(s)" reads better
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self._walk(s.split()) if w is not None)
        return self.postprocess(s)


class EnglishSpellingNormalizer:
    """British→American spellings from the vendored data table
    (english.py:443-455; the json is data, not code)."""

    def __init__(self, spelling_file: str = _SPELLING_ASSET):
        with open(spelling_file) as f:
            self.mapping: Dict[str, str] = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in s.split())


_REPLACERS: Dict[str, str] = {
    # common contractions
    r"\bwon't\b": "will not",
    r"\bcan't\b": "can not",
    r"\blet's\b": "let us",
    r"\bain't\b": "aint",
    r"\by'all\b": "you all",
    r"\bwanna\b": "want to",
    r"\bgotta\b": "got to",
    r"\bgonna\b": "going to",
    r"\bi'ma\b": "i am going to",
    r"\bimma\b": "i am going to",
    r"\bwoulda\b": "would have",
    r"\bcoulda\b": "could have",
    r"\bshoulda\b": "should have",
    r"\bma'am\b": "madam",
    # titles / honorifics
    r"\bmr\b": "mister ",
    r"\bmrs\b": "missus ",
    r"\bst\b": "saint ",
    r"\bdr\b": "doctor ",
    r"\bprof\b": "professor ",
    r"\bcapt\b": "captain ",
    r"\bgov\b": "governor ",
    r"\bald\b": "alderman ",
    r"\bgen\b": "general ",
    r"\bsen\b": "senator ",
    r"\brep\b": "representative ",
    r"\bpres\b": "president ",
    r"\brev\b": "reverend ",
    r"\bhon\b": "honorable ",
    r"\basst\b": "assistant ",
    r"\bassoc\b": "associate ",
    r"\blt\b": "lieutenant ",
    r"\bcol\b": "colonel ",
    r"\bjr\b": "junior ",
    r"\bsr\b": "senior ",
    r"\besq\b": "esquire ",
    # perfect tenses before the generic 's/'d rules
    r"'d been\b": " had been",
    r"'s been\b": " has been",
    r"'d gone\b": " had gone",
    r"'s gone\b": " has gone",
    r"'d done\b": " had done",
    r"'s got\b": " has got",
    # general contractions
    r"n't\b": " not",
    r"'re\b": " are",
    r"'s\b": " is",
    r"'d\b": " would",
    r"'ll\b": " will",
    r"'t\b": " not",
    r"'ve\b": " have",
    r"'m\b": " am",
}

_FILLERS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"


class EnglishTextNormalizer:
    """The full English normalisation pass (english.py:457-543)."""

    def __init__(self, spelling_file: Optional[str] = _SPELLING_ASSET):
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = (
            EnglishSpellingNormalizer(spelling_file)
            if spelling_file and os.path.exists(spelling_file)
            else None
        )

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = re.sub(_FILLERS, "", s)
        s = re.sub(r"\s+'", "'", s)  # standalone apostrophe spacing
        for pattern, repl in _REPLACERS.items():
            s = re.sub(pattern, repl, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # 1,000 → 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # keep decimal points only
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        s = self.standardize_numbers(s)
        if self.standardize_spellings is not None:
            s = self.standardize_spellings(s)

        # symbols kept for numerics are dropped when not digit-adjacent
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        return re.sub(r"\s+", " ", s).strip()
