"""Grapheme/ARPAbet text frontend.

Public API (same surface as the reference, CookieTTS/utils/text/__init__.py):
- :func:`text_to_sequence` — text (with optional ``{ARPA}`` curly-brace
  escapes) → list of symbol IDs.
- :func:`sequence_to_text` — inverse, re-wrapping phones in braces.
Host-side, pure Python; the model consumes the resulting int32 arrays.
"""
from __future__ import annotations

import re
from typing import List, Sequence

from .cleaners import CLEANERS
from .symbols import ID_TO_SYMBOL, N_SYMBOLS, SYMBOL_TO_ID, symbols  # noqa: F401

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    """Convert text to a sequence of symbol IDs.

    Curly-brace spans are treated as space-separated ARPAbet phones:
    ``"Turn left on {HH AW1 S} Street."``
    """
    sequence: List[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    """Inverse of :func:`text_to_sequence` (phones re-wrapped in braces)."""
    result = ""
    for symbol_id in sequence:
        s = ID_TO_SYMBOL.get(int(symbol_id))
        if s is None:
            continue
        if len(s) > 1 and s[0] == "@":
            s = "{%s}" % s[1:]
        result += s
    return result.replace("}{", " ")


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        cleaner = CLEANERS.get(name)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms: str) -> List[int]:
    return [SYMBOL_TO_ID[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s: str) -> bool:
    return s in SYMBOL_TO_ID and s != "_" and s != "~"
