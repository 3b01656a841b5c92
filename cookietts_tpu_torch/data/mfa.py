"""Montreal Forced Aligner output: the TextGrid reader and the frame
durations of its intervals (cookietts_tpu/data/mfa.py:87-112; the reference
CookieTTS/utils/dataset/MFA.py). Running the aligner itself waits for the
port's ``preprocess`` command."""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_INTERVAL_RE = re.compile(
    r'intervals \[\d+\]:\s*xmin = ([\d.]+)\s*xmax = ([\d.]+)\s*'
    r'text = "([^"]*)"', re.S)
_TIER_RE = re.compile(r'item \[\d+\]:\s*class = "IntervalTier"\s*'
                      r'name = "([^"]+)"')


def parse_textgrid(path: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """TextGrid -> {tier_name: [(start, end, label), ...]}."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    tier_spans = [(m.start(), m.group(1)) for m in _TIER_RE.finditer(text)]
    tier_spans.append((len(text), ""))
    for (start, name), (end, _) in zip(tier_spans, tier_spans[1:]):
        chunk = text[start:end]
        tiers[name] = [(float(a), float(b), lbl)
                       for a, b, lbl in _INTERVAL_RE.findall(chunk)]
    return tiers


def durations_from_textgrid(tiers: Dict[str, List[Tuple[float, float, str]]],
                            tier: str, hop_seconds: float) -> List[int]:
    """Phone/word intervals -> integer frame durations at hop rate, the
    rounding remainder carried to the next interval."""
    out = []
    acc = 0.0
    for start, end, _ in tiers.get(tier, []):
        exact = (end - start) / hop_seconds + acc
        frames = int(round(exact))
        acc = exact - frames
        out.append(max(frames, 0))
    return out
