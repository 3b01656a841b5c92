"""Archive extraction dispatch (a copy of cookietts_tpu/data/extract.py).

Rebuild of CookieTTS/utils/dataset/extract_unknown.py:6-27: pick the right
extractor from the file extension (zip / tar / tar.gz / tar.bz2 / 7z).
7z falls back to the ``7z`` CLI when py7zr is unavailable.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tarfile
import zipfile

ARCHIVE_EXTS = (".zip", ".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz2",
                ".7z")


def is_archive(path: str) -> bool:
    low = path.lower()
    return any(low.endswith(e) for e in ARCHIVE_EXTS)


def extract(path: str, dest: str | None = None) -> str:
    """Extract ``path`` next to itself (or into ``dest``). Returns dest."""
    dest = dest or os.path.dirname(os.path.abspath(path))
    os.makedirs(dest, exist_ok=True)
    low = path.lower()
    if low.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
    elif low.endswith((".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz2")):
        with tarfile.open(path) as t:
            t.extractall(dest, filter="data")
    elif low.endswith(".7z"):
        try:
            import py7zr
            with py7zr.SevenZipFile(path) as z:
                z.extractall(dest)
        except ImportError:
            exe = shutil.which("7z") or shutil.which("7za")
            if exe is None:
                raise RuntimeError(
                    "no py7zr and no 7z binary available for " + path)
            subprocess.run([exe, "x", "-y", f"-o{dest}", path], check=True)
    else:
        raise ValueError(f"unknown archive type: {path}")
    return dest
