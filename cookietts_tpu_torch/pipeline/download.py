"""Config-driven dataset acquisition (a copy of
cookietts_tpu/pipeline/download.py).

Capability rebuild of CookieTTS/_0_download/ (start_download.py +
scripts/): each dataset entry in the JSON config lists its URLs and
fetch method; HTTP downloads stream with a progress callback
(scripts/download_urls.py:7-42), Google-Drive / Mega fetches shell out to
the external ``gdown`` / ``megatools`` binaries when present
(scripts/download_mega.py:1-33), and archives are extracted recursively.

Config format (mirrors _0_download/config.json):
    {"datasets": [{"name": "LJSpeech", "method": "http",
                   "urls": ["https://.../LJSpeech-1.1.tar.bz2"],
                   "dest": "datasets/LJSpeech", "extract": true}]}
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from ..data.extract import extract, is_archive


def download_http(url: str, dest_path: str,
                  progress: Optional[Callable[[int, int], None]] = None,
                  chunk: int = 1 << 20) -> str:
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    req = urllib.request.Request(url, headers={"User-Agent": "cookietts"})
    with urllib.request.urlopen(req) as resp, \
            open(dest_path + ".part", "wb") as f:
        total = int(resp.headers.get("Content-Length") or 0)
        done = 0
        while True:
            buf = resp.read(chunk)
            if not buf:
                break
            f.write(buf)
            done += len(buf)
            if progress:
                progress(done, total)
    os.replace(dest_path + ".part", dest_path)
    return dest_path


def download_gdrive(file_id: str, dest_path: str) -> str:
    exe = shutil.which("gdown")
    if exe is None:
        raise RuntimeError("gdown binary not available for Google Drive "
                           f"download of {file_id}")
    subprocess.run([exe, "--id", file_id, "-O", dest_path], check=True)
    return dest_path


MEGATOOLS_LINUX_URL = ("https://megatools.megous.com/builds/experimental/"
                       "megatools-1.11.0-git-20200503-linux-x86_64.tar.gz")


def ensure_megatools(tools_dir: Optional[str] = None) -> Optional[str]:
    """Locate — or auto-download, like the reference
    (_0_download/scripts/download_mega.py:1-33) — a megatools binary.
    Returns the executable path, or None when unavailable."""
    for name in ("megadl", "megatools"):
        exe = shutil.which(name)
        if exe:
            return exe
    tools_dir = tools_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "cookietts_tpu")
    binary_folder = os.path.join(
        tools_dir, os.path.basename(MEGATOOLS_LINUX_URL)[: -len(".tar.gz")])
    exe = os.path.join(binary_folder, "megatools")
    if os.path.exists(exe):
        return exe
    try:
        os.makedirs(tools_dir, exist_ok=True)
        archive = os.path.join(tools_dir,
                               os.path.basename(MEGATOOLS_LINUX_URL))
        download_http(MEGATOOLS_LINUX_URL, archive)
        extract(archive, tools_dir)
        return exe if os.path.exists(exe) else None
    except Exception as e:
        print(f"[download] megatools auto-download failed: {e!r}")
        return None


def download_mega(url: str, dest_dir: str) -> str:
    exe = ensure_megatools()
    if exe is None:
        raise RuntimeError(f"megatools not available for {url} and "
                           "auto-download failed")
    if os.path.basename(exe).startswith("megadl"):
        subprocess.run([exe, f"--path={dest_dir}", url], check=True)
    else:
        subprocess.run([exe, "dl", "--path", dest_dir, url], check=True)
    return dest_dir


def download_clipper_master(entry: Dict[str, Any]) -> List[str]:
    """The Clipper MLP master-folder special case
    (_0_download/scripts/download_clipper.py:22-30): one giant mega.nz
    folder pulled into the dataset dir (multi-day on free bandwidth)."""
    dest = entry.get("dest", entry["name"])
    os.makedirs(dest, exist_ok=True)
    print("[download] Clipper master folder via mega.nz — this can take "
          "days on free bandwidth limits")
    download_mega(entry["url"] if "url" in entry else entry["urls"][0],
                  dest)
    return [dest]


def _select_libritts_urls(entry: Dict[str, Any]) -> List[str]:
    """LibriTTS clean/other split selection
    (reference start_download.py:56-68)."""
    urls: List[str] = []
    if entry.get("download_clean", True):
        urls += entry.get("urls_clean", [])
    if entry.get("download_other", False):
        urls += entry.get("urls_other", [])
    return urls


def download_dataset(entry: Dict[str, Any],
                     progress: Optional[Callable] = None) -> List[str]:
    """Fetch one config entry. Returns the list of downloaded paths."""
    method = entry.get("method", "http")
    if method == "clipper_master":
        return download_clipper_master(entry)
    dest = entry.get("dest", entry["name"])
    os.makedirs(dest, exist_ok=True)
    urls = list(entry.get("urls", []))
    if "urls_clean" in entry or "urls_other" in entry:
        urls += _select_libritts_urls(entry)
    paths: List[str] = []
    for url in urls:
        fname = os.path.join(dest, url.rstrip("/").split("/")[-1])
        if os.path.exists(fname):
            paths.append(fname)
            continue
        if method == "http":
            paths.append(download_http(url, fname, progress))
        elif method == "gdrive":
            paths.append(download_gdrive(url, fname))
        elif method == "mega":
            paths.append(download_mega(url, dest))
        else:
            raise ValueError(f"unknown download method {method!r}")
    if entry.get("extract", True):
        for p in list(paths):
            if is_archive(p):
                extract(p, dest)
    return paths


def run_downloads(config_path: str) -> None:
    """The `python start_download.py` equivalent."""
    with open(config_path) as f:
        config = json.load(f)
    for entry in config.get("datasets", []):
        if not entry.get("enabled", True):
            continue
        print(f"[download] {entry['name']}")
        download_dataset(entry)
