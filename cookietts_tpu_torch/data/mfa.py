"""Montreal Forced Aligner wrapper (host-side, external binary; a copy of
cookietts_tpu/data/mfa.py).

Capability rebuild of CookieTTS/utils/dataset/MFA.py:1-46,74+: run MFA
per speaker over (wav, txt) pairs, parse the TextGrid output into word /
phone timings, and report out-of-vocabulary words. The binary itself is
an external tool: ``ensure_mfa`` fetches v1.0.1 as the reference does when
the network allows, else its path is given or found on PATH.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple


MFA_LINUX_URL = ("https://github.com/MontrealCorpusTools/"
                 "Montreal-Forced-Aligner/releases/download/v1.0.1/"
                 "montreal-forced-aligner_linux.tar.gz")


def find_mfa() -> Optional[str]:
    return shutil.which("mfa_align") or shutil.which("mfa")


def ensure_mfa(dest_dir: str, url: str = MFA_LINUX_URL) -> str:
    """Auto-download MFA v1.0.1 into ``dest_dir`` and return the
    ``mfa_align`` binary path (reference MFA.py:1-46, incl. the
    libpython3.6m.so hotfix hard-link). Reuses an existing install;
    requires network egress otherwise."""
    root = os.path.join(dest_dir, "montreal-forced-aligner")
    binary = os.path.join(root, "bin", "mfa_align")
    if os.path.exists(binary):
        return binary
    os.makedirs(dest_dir, exist_ok=True)
    archive = os.path.join(dest_dir, url.rsplit("/", 1)[-1])
    if not os.path.exists(archive):
        import urllib.request
        try:
            urllib.request.urlretrieve(url, archive)
        except OSError as e:
            raise RuntimeError(
                f"MFA auto-download failed ({e}); install MFA manually "
                f"and pass mfa_binary") from e
    from .extract import extract
    extract(archive, dest_dir)
    os.unlink(archive)
    # v1.0.1 ships lib/libpython3.6m.so.1.0 but the binary links
    # lib/libpython3.6m.so (a packaging bug of the MFA release)
    so = os.path.join(root, "lib", "libpython3.6m.so")
    if not os.path.exists(so) and os.path.exists(so + ".1.0"):
        os.link(so + ".1.0", so)
    if not os.path.exists(binary):
        raise RuntimeError(f"MFA archive extracted but {binary} missing")
    return binary


def run_alignment(corpus_dir: str, lexicon_path: str, out_dir: str,
                  mfa_binary: Optional[str] = None,
                  acoustic_model: str = "english") -> str:
    """Run forced alignment over a prepared corpus directory
    (wav + matching .txt/.lab per file). Returns the TextGrid dir."""
    mfa = mfa_binary or find_mfa()
    if mfa is None:
        raise RuntimeError(
            "Montreal Forced Aligner binary not found; install it or pass "
            "mfa_binary. (The reference auto-downloads v1.0.1 — "
            "CookieTTS/utils/dataset/MFA.py:1-46.)")
    os.makedirs(out_dir, exist_ok=True)
    if os.path.basename(mfa).startswith("mfa_align"):
        cmd = [mfa, corpus_dir, lexicon_path, acoustic_model, out_dir]
    else:     # mfa >= 2.0 CLI
        cmd = [mfa, "align", corpus_dir, lexicon_path, acoustic_model,
               out_dir]
    subprocess.run(cmd, check=True)
    return out_dir


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
    """Phone/word intervals -> integer frame durations at hop rate."""
    out = []
    acc = 0.0
    for start, end, _ in tiers.get(tier, []):
        exact = (end - start) / hop_seconds + acc
        frames = int(round(exact))
        acc = exact - frames
        out.append(max(frames, 0))
    return out


def arpa_from_alignment(
        quote: str,
        words: List[Tuple[float, float, str]],
        phones: List[Tuple[float, float, str]],
        punc: str = "!?,.;:␤#-_'\"()[]\n") -> str:
    """Rebuild the transcript with each aligned word replaced by its
    ``{PH PH ...}`` phone string, punctuation peeled and re-attached
    (reference MFA.py:49-101 get/get_arpa).

    ``words``/``phones`` are (start, end, label) interval lists from
    :func:`parse_textgrid`; silence phones (``sil``/``sp``/empty) are
    skipped. Words in ``quote`` with no aligned interval left are kept
    as graphemes.
    """
    content = [(s, e, t) for s, e, t in phones
               if t and t not in ("sil", "sp")]
    word_phones: List[str] = []
    for ws, we, wt in words:
        if not wt:
            continue
        mine = [t for s, e, t in content
                if s >= ws - 1e-6 and e <= we + 1e-6]
        word_phones.append(" ".join(mine))
    out = []
    for token in quote.split(" "):
        head, tail, core = "", "", token
        while core and any(c in punc for c in core) and len(core) > 1:
            if core[-1] in punc:
                tail = core[-1] + tail
                core = core[:-1]
            elif core[0] in punc:
                head = head + core[0]
                core = core[1:]
            else:
                break
        # only WORD tokens consume an aligned phone group — standalone
        # punctuation / empty tokens have no MFA word interval, and
        # popping for them would shift every later pronunciation (the
        # reference's get() has exactly this off-by-one, MFA.py:53-72)
        is_word = any(c.isalnum() for c in core)
        if is_word and word_phones:
            ph = word_phones.pop(0)
            if ph:
                core = "{" + ph + "}"
        out.append((head + core + tail).rstrip())
    return " ".join(out)


def oov_words(transcripts: List[str], lexicon: Dict[str, str]) -> List[str]:
    """Words missing from the pronunciation lexicon (missing-vocab dump,
    reference _1_preprocess/start_preprocess.py:554-598)."""
    missing = set()
    for t in transcripts:
        for w in re.findall(r"[A-Za-z']+", t):
            if w.upper() not in lexicon:
                missing.add(w.lower())
    return sorted(missing)
