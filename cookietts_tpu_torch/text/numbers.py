"""Number → spoken-English expansion, written from scratch (no `inflect`).

Capability parity with the reference's number normalization
(reference: CookieTTS/utils/text/numbers.py:64-71 — commas stripped,
currency, decimals, ordinals, and the year-style reading of 1000..3000).
The environment does not ship `inflect`, so the number-to-words core is
implemented here directly.
"""
from __future__ import annotations

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 18, "quintillion"),
    (10 ** 15, "quadrillion"),
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (100, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def number_to_words(n: int) -> str:
    """Spell an integer in English ('one hundred twenty-three')."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _under_100(n)
    parts = []
    for scale_val, scale_name in _SCALES:
        if n >= scale_val:
            q, n = divmod(n, scale_val)
            parts.append(number_to_words(q) + " " + scale_name)
    if n:
        parts.append(_under_100(n))
    return " ".join(parts)


def number_to_words_ordinal(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    hy_head, hy, hy_last = last.rpartition("-")
    if hy_last in _ORDINAL_IRREGULAR:
        ord_last = hy_head + hy + _ORDINAL_IRREGULAR[hy_last]
    elif hy_last.endswith("y"):
        ord_last = hy_head + hy + hy_last[:-1] + "ieth"
    else:
        ord_last = hy_head + hy + hy_last + "th"
    return (head + " " if head else "") + ord_last


def _year_style(n: int) -> str:
    """Two-digit-grouped reading used for 1000 < n < 3000 ('nineteen oh-five')."""
    hi, lo = divmod(n, 100)
    if lo == 0:
        return number_to_words(hi) + " hundred"
    lo_words = ("oh " + _UNITS[lo]) if lo < 10 else _under_100(lo)
    return _under_100(hi) + " " + lo_words


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format, leave digits alone
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        d_unit = "dollar" if dollars == 1 else "dollars"
        c_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {d_unit}, {cents} {c_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return number_to_words_ordinal(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + _UNITS[num % 100]
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return _year_style(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    """Expand digits/currency/ordinals into words (same pass order as the
    reference: commas → pounds → dollars → decimals → ordinals → numbers)."""
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
