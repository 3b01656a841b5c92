"""The PyTorch port stands alone: it imports neither jax nor cookietts_tpu,
and its entry points run on the card unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "cookietts_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cookietts_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
FORBIDDEN = {forbidden!r}

def forbidden(name):
    return name.split(".")[0] in FORBIDDEN

for name in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[name]      # e.g. imported by a sitecustomize

class Block:
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError("the port imported " + name)

sys.meta_path.insert(0, Block())
import cookietts_tpu_torch
for mod in pkgutil.walk_packages(cookietts_tpu_torch.__path__,
                                 "cookietts_tpu_torch."):
    importlib.import_module(mod.name)
leaked = sorted(m for m in sys.modules if forbidden(m))
assert not leaked, leaked
print("imported", len([m for m in sys.modules
                       if m.startswith("cookietts_tpu_torch")]))
"""


def test_import_every_module_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=FORBIDDEN)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 10


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statements(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = Tacotron2Config(
        n_symbols=20, symbols_embedding_dim=8, n_speakers=2,
        speaker_embedding_dim=4, encoder_speaker_embed_dim=2,
        encoder_conv_hidden_dim=8, encoder_lstm_dim=8, torchmoji_dim=4,
        torchmoji_crushed_dim=2, memory_bottleneck_dim=8, prenet_dim=4,
        attention_rnn_dim=8, decoder_rnn_dim=8, second_decoder_rnn_dim=8,
        attention_dim=4, postnet_embedding_dim=8)
    hcfg = HiFiGANConfig(upsample_initial_channel=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tacotron2(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(hcfg)
    taco = Tacotron2(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        T2S(T2SConfig(), taco, {"a": 0})
    T2S(T2SConfig(), taco, {"a": 0}, device="cpu")
    Generator(hcfg, device="cpu")
