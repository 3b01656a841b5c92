"""Text cleaners (normalization passes run at train and eval time).

Same cleaner inventory as the reference (CookieTTS/utils/text/cleaners.py):
``basic_cleaners`` (the tacotron2_tm default, hparams.py:102),
``transliteration_cleaners``, and ``english_cleaners``.

The environment does not ship `unidecode`; ASCII transliteration is done
with a unicodedata NFKD decomposition + combining-mark strip, which covers
accented Latin text (the dominant case for TTS corpora).
"""
from __future__ import annotations

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

# Abbreviation expansion table (standard keithito-tacotron set).
_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("drs", "doctors"),
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
    """Transliterate to ASCII (NFKD decomposition, drop combining marks)."""
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text: str) -> str:
    """Expand numbers and collapse whitespace, no transliteration or casing."""
    text = expand_numbers(text)
    text = collapse_whitespace(text)
    return text


def transliteration_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def english_cleaners(text: str) -> str:
    """English pipeline: number + abbreviation expansion (case preserved,
    matching the reference which has lowercasing commented out)."""
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
