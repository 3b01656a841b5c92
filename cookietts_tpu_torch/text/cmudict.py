"""CMU pronouncing dictionary loader (cookietts_tpu/text/cmudict.py).

Capability parity with the reference's two dictionary front-ends:
- :class:`CMUDict` — the keithito-style parser over official cmudict files
  (reference: CookieTTS/utils/text/cmudict.py:19-80).
- :class:`ARPADict` — the simpler one-pronunciation-per-line merged.dict
  lookup with punctuation peeling (reference: CookieTTS/utils/text/ARPA.py).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from .cleaners import convert_to_ascii
from .symbols import ARPABET_PHONES

_VALID_PHONES = set(ARPABET_PHONES)
_alt_re = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Word → list-of-pronunciations lookup over a cmudict-format file."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())


def _parse_cmudict(file) -> Dict[str, List[str]]:
    cmudict: Dict[str, List[str]] = {}
    for line in file:
        if len(line) and ("A" <= line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = re.sub(_alt_re, "", parts[0])
            pron = _get_pronunciation(parts[1])
            if pron:
                cmudict.setdefault(word, []).append(pron)
    return cmudict


def _get_pronunciation(s: str) -> Optional[str]:
    parts = s.strip().split(" ")
    for part in parts:
        if part not in _VALID_PHONES:
            return None
    return " ".join(parts)


class ARPADict:
    """merged.dict-style lookup that converts a text block to {ARPA} escapes.

    Punctuation is peeled off each word's edges before lookup and re-attached
    after, so "Hello," becomes "{HH AH0 L OW1},".
    """

    PUNC = "!?,.;:␤#-_'\"()[]\n"

    def __init__(self, dict_path: str):
        self.arpadict: Dict[str, str] = {}
        with open(dict_path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    self.arpadict[convert_to_ascii(parts[0])] = convert_to_ascii(
                        " ".join(parts[1:]).strip()
                    )

    def get(self, text: str) -> str:
        out = []
        for word in text.split(" "):
            start_chars = ""
            end_chars = ""
            while any(c in word for c in self.PUNC) and len(word) > 1:
                if word[-1] in self.PUNC:
                    end_chars = word[-1] + end_chars
                    word = word[:-1]
                elif word[0] in self.PUNC:
                    start_chars = start_chars + word[0]
                    word = word[1:]
                else:
                    break
            pron = self.arpadict.get(word.upper())
            if pron is not None:
                word = "{" + pron + "}"
            out.append((start_chars + (word or "") + end_chars).rstrip())
        return " ".join(out)
