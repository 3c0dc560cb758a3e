"""The port's text normalizers against the JAX package's: equal strings on
every case of tests/test_text_normalizers.py and on the tokenizer corpus of
tests/test_torch_whisper_decoding.py."""

import pytest

from svc_inference_pipeline_tpu.models import text_normalizers as J
from svc_inference_pipeline_tpu_torch.models import text_normalizers as P
from test_torch_whisper_decoding import corpus

BASIC = ["Hello, World!", "[noise] spoken (laughs) text", "  a   b\tc ", "café naïve"]
ENGLISH = [
    "I'm sure it won't rain, y'all", "they're can't don't", "Mr. Smith", "1,000 items.", "it costs $3.50!",
    "the colour of favour",
    "Mr. Brown paid $1.50 for the 3rd ticket, didn't he?",
    "It's twenty-one degrees colour-wise, favourite colours!",
    "[MUSIC] She said (quietly) um, I'd been there for nineteen sixty s",
    "He'll've... uh, y'all gonna organise the programme?",
    "THREE THOUSAND FIVE HUNDRED AND FORTY-TWO dollars",
    "she's been there, he'd gone, it's got to be 5 per cent",
]
NUMBERS = [
    "twenty one", "one oh one", "double oh seven", "twenty dollars", "twenty dollars and seven cents",
    "fifty percent", "three per cent", "thirty second", "two hundred seventy fourth", "minus three point five",
    "one million three hundred thousand", "one", "ones and zero", "seven and a half", "the 1960 s were",
    "thirty twos",
    "twenty one dollars", "one hundred and five", "nineteen sixty s", "the 1960s were wild",
    "two hundred five thousand", "three point one four one five nine", "minus seven degrees",
    "$20 million", "twenty million dollars", "thirty second street", "two thirds", "triple nine",
    "a hundred and one dalmatians", "seven and a half hours", "two and a half",
    "one point five million dollars", "first second third fourth fifth", "twelfth night",
    "four hundredths", "ten thousandths", "sixes and sevens", "twenties thirties forties",
    "one two three four", "oh one two", "ninety nine bottles", "plus five", "positive ten",
    "negative three point five", "1,234,567 things", "version 2.5.1 released", "he is 6 foot 2",
    "it cost $1.50", "3rd place", "22nd of may", "1st and 2nd", "one thousand and one nights",
    "zero point zero zero one", "a million", "half a million", "one and a half", "nineteen eighty four",
    "two thousand and twenty three", "one dollar", "one cent", "ones and zeros", "point five", "and",
    "double trouble", "triple a", "per cent", "percent alone",
]
ALL = BASIC + ENGLISH + NUMBERS + corpus()


@pytest.mark.parametrize("name", ["basic", "basic_diacritics", "number", "spelling", "english",
                                  "english_no_spelling"])
def test_normalizers_match_jax(name):
    make = {
        "basic": lambda m: m.BasicTextNormalizer(),
        "basic_diacritics": lambda m: m.BasicTextNormalizer(remove_diacritics=True),
        "number": lambda m: m.EnglishNumberNormalizer(),
        "spelling": lambda m: m.EnglishSpellingNormalizer(),
        "english": lambda m: m.EnglishTextNormalizer(),
        "english_no_spelling": lambda m: m.EnglishTextNormalizer(spelling_file=None),
    }[name]
    ours, theirs = make(P), make(J)
    for text in ALL:
        assert ours(text) == theirs(text), repr(text)


def test_spelling_table_read_from_the_jax_assets():
    norm = P.EnglishTextNormalizer()
    assert norm.standardize_spellings is not None
    assert norm("the colour of favour") == "the color of favor"
    assert P.EnglishSpellingNormalizer().mapping == J.EnglishSpellingNormalizer().mapping


def test_split_letters_splits_grapheme_clusters():
    """A cluster is a base character and the combining marks after it; the
    JAX copy raises here (stdlib ``re`` has no ``\\X``)."""
    assert P.BasicTextNormalizer(split_letters=True)("abc") == "a b c"
    assert P.BasicTextNormalizer(split_letters=True)("Hi, yo") == "h i y o"
    assert P.graphemes("a\u0307b\u0301c") == ["a\u0307", "b\u0301", "c"]
    assert P.graphemes("e\u0301\u0323 x") == ["e\u0301\u0323", " ", "x"]
    plain = P.BasicTextNormalizer()
    for text in ALL:
        assert plain(text) == J.BasicTextNormalizer()(text), repr(text)
