"""Symbol inventory for the text frontend.

The ID space must be bit-identical to the reference so that text sequences,
checkpoints and golden tests interoperate
(reference: CookieTTS/utils/text/symbols.py:9-22 — pad, punctuation,
letters, @-prefixed ARPAbet, then the custom control glyphs).

Layout (in ID order):
  0       : pad '_'
  1       : special '-'
  2..11   : punctuation  !'(),.:;?␣
  12..63  : A-Z a-z
  64..147 : @ARPAbet phones (84 symbols incl. stress variants)
  148..   : custom control glyphs (☺ start, ␤ stop, ♫/♪ singing, etc.)
"""

# ARPAbet phone inventory (CMU dictionary standard; stress-marked vowels).
# Reference: CookieTTS/utils/text/cmudict.py:6-14.
ARPABET_PHONES = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1", "AH2",
    "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2", "EY",
    "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1",
    "IY2", "JH", "K", "L", "M", "N", "NG", "OW", "OW0", "OW1", "OW2", "OY", "OY0",
    "OY1", "OY2", "P", "R", "S", "SH", "T", "TH", "UH", "UH0", "UH1", "UH2", "UW",
    "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]

PAD = "_"
PUNCTUATION = "!'(),.:;? "
SPECIAL = "-"
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
# Control glyphs: ☺ = start token, ␤ = stop token, # = singing hold-note,
# ♫ = singing mode; the rest are reserved (same inventory as the reference).
CUSTOM = "☺␤☻♥♦♣♠•◘○◙♂♀♪♫☼►◄↕#¶§▬↨↑↓→←∟↔▲"

_arpabet_symbols = ["@" + p for p in ARPABET_PHONES]

symbols = (
    [PAD] + list(SPECIAL) + list(PUNCTUATION) + list(LETTERS)
    + _arpabet_symbols + list(CUSTOM)
)

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}

N_SYMBOLS = len(symbols)
