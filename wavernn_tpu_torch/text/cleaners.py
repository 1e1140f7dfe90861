"""Text cleaner pipelines (reference utils/text/cleaners.py).

``unidecode`` is used when installed; otherwise a NFKD-based ASCII
transliteration fallback keeps the pipeline dependency-free.
"""
from __future__ import annotations

import re
import unicodedata

from .numbers_en import normalize_numbers

# Characters NFKD cannot decompose to ASCII but real unidecode maps;
# covers the Latin-script + typographic-punctuation set that occurs in
# LJSpeech-style English corpora. Values are pinned to real unidecode
# output (tests/test_text.py::test_unidecode_fallback_fidelity).
_TRANSLIT = {
    "ß": "ss", "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "Th", "ł": "l", "Ł": "L",
    "–": "-", "—": "--", "‘": "'", "’": "'",
    "“": '"', "”": '"', "…": "...", "×": "x",
}
_TRANSLIT_RE = re.compile("|".join(map(re.escape, _TRANSLIT)))

def _unidecode_fallback(text: str) -> str:
    """NFKD + table fallback. Matches real unidecode on Latin-script
    input; non-Latin scripts (Cyrillic, CJK, ...) degrade to '' where
    unidecode would transliterate — acceptable for the English cleaners
    this frontend ships (reference utils/text/cleaners.py)."""
    text = _TRANSLIT_RE.sub(lambda m: _TRANSLIT[m.group(0)], text)
    return (unicodedata.normalize("NFKD", text)
            .encode("ascii", "ignore").decode("ascii"))


try:  # optional dependency
    from unidecode import unidecode as _unidecode
except ImportError:  # pragma: no cover
    _unidecode = _unidecode_fallback

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    return _unidecode(text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
