"""The PyTorch port stands alone: it imports neither jax nor cookietts_tpu,
and its entry points run on the card unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_threads import _one_thread  # noqa: F401


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
for name in ("cookietts_tpu_torch.runtime.export_serving",
             "cookietts_tpu_torch.audio.iso226",
             "cookietts_tpu_torch.pipeline.gta",
             "cookietts_tpu_torch.models.gan_postnet",
             "cookietts_tpu_torch.models.hifigan_denoiser",
             "cookietts_tpu_torch.data.denoiser_data",
             "cookietts_tpu_torch.models.untts",
             "cookietts_tpu_torch.models.gantts",
             "cookietts_tpu_torch.data.dio",
             "cookietts_tpu_torch.data.mfa",
             "cookietts_tpu_torch.utils",
             "cookietts_tpu_torch.audio.dsp",
             "cookietts_tpu_torch.audio.features",
             "cookietts_tpu_torch.audio.processing",
             "cookietts_tpu_torch.data.extract",
             "cookietts_tpu_torch.data.native",
             "cookietts_tpu_torch.pipeline.download",
             "cookietts_tpu_torch.pipeline.preprocess"):
    assert name in sys.modules, name
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
                         + [ROOT / "chip_smoke.py"]
                         + [ROOT / "tools" / name for name in (
                             "bench_wn_tiles.py", "bench_mma_rate.py",
                             "bench_resblock_parts.py", "bench_attention.py")],
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


@pytest.mark.parametrize("entry", ["waveglow", "waveflow", "stft", "denoiser",
                                   "iso226"])
def test_flow_vocoder_entry_points_raise_without_cuda(monkeypatch, entry):
    from cookietts_tpu_torch.audio.iso226 import ISO226
    from cookietts_tpu_torch.audio.stft import STFT
    from cookietts_tpu_torch.models.denoiser import Denoiser
    from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = WaveGlowConfig(
        n_mel_channels=4, n_flows=2, n_group=4, n_early_every=0, n_layers=1,
        n_channels=8, hop_length=8, upsample_strides=(2,), upsample_channels=4,
        channel_mixing="permuteheight" if entry == "waveflow" else "1x1conv")
    silent = lambda mel, generator: torch.zeros(1, 600)
    make = {"waveglow": lambda **kw: WaveGlow(cfg, **kw),
            "waveflow": lambda **kw: WaveGlow(cfg, **kw),
            "stft": lambda **kw: STFT(64, 16, 64, **kw),
            "denoiser": lambda **kw: Denoiser(silent, sampling_rate=4000,
                                              n_mel_channels=4, **kw),
            "iso226": lambda **kw: ISO226(8000, 64, 16, 64, **kw).stft}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["mpd", "msd", "train-hifigan",
                                   "train-waveglow"])
def test_vocoder_training_entry_points_raise_without_cuda(monkeypatch,
                                                         tmp_path, entry):
    """The discriminators and the vocoder train commands (whose modules,
    data/mel2samp.py and ops/dtw.py among them, the import tests above
    cover) run on the card unless asked for the CPU."""
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.hifigan import (HiFiGANConfig,
                                                    MultiPeriodDiscriminator,
                                                    MultiScaleDiscriminator)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HiFiGANConfig(mpd_periods=(2,), msd_scales=1)
    make = {"mpd": lambda **kw: MultiPeriodDiscriminator(cfg, **kw),
            "msd": lambda **kw: MultiScaleDiscriminator(cfg, **kw)}.get(entry)
    if make is None:
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(["train", "--model", entry.split("-")[1], "--filelist",
                 str(tmp_path / "map.txt"), "--run_dir", str(tmp_path)])
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    make(device="cpu")


@pytest.mark.parametrize("entry", ["untts", "gantts-generator",
                                   "gantts-discriminator", "train-untts",
                                   "train-gantts"])
def test_nar_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    """UnTTS, the GAN-TTS models and their train commands run on the card
    unless asked for the CPU."""
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.gantts import (GANTTSConfig,
                                                   GANTTSDiscriminator,
                                                   GANTTSGenerator)
    from cookietts_tpu_torch.models.untts import UnTTS, UnTTSConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ucfg = UnTTSConfig(n_symbols=8, symbols_embedding_dim=8, n_speakers=2,
                       speaker_embedding_dim=4, n_mel_channels=4, enc_layers=1,
                       enc_ffn_dim=8, predictor_filter_size=4,
                       dec_n_flows=1, dec_n_layers=1, dec_n_channels=8)
    gcfg = GANTTSConfig(n_symbols=8, symbols_embedding_dim=8, n_speakers=2,
                        speaker_embedding_dim=4, n_mel_channels=4, z_dim=4,
                        enc_layers=1, enc_ffn_dim=8, g_channels=(8,),
                        d_channels=(4,), d_windows=(8,))
    make = {"untts": lambda **kw: UnTTS(ucfg, **kw),
            "gantts-generator": lambda **kw: GANTTSGenerator(gcfg, **kw),
            "gantts-discriminator": lambda **kw: GANTTSDiscriminator(gcfg,
                                                                     **kw)
            }.get(entry)
    if make is None:
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(["train", "--model", entry.split("-")[1], "--filelist",
                 str(tmp_path / "filelist.txt"), "--run_dir", str(tmp_path)])
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert next(make(device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("entry", ["torchmoji", "encoder", "tts", "server"])
def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    """torchMoji, its encoder and the tts / server commands (through
    _build_t2s) run on the card unless asked for the CPU."""
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.torchmoji import TorchMoji, TorchMojiEncoder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = TorchMoji(16, device="cpu").state_dict()
    ckpt = str(tmp_path / "taco.pt")
    make = {
        "torchmoji": lambda *a: TorchMoji(16, *a),
        "encoder": lambda *a: TorchMojiEncoder({}, weights, 30, *a),
        "tts": lambda *a: cli(["tts", "--checkpoint", ckpt, "--text", "x"]
                              + (["--device", *a] if a else [])),
        "server": lambda *a: cli(["server", "--checkpoint", ckpt]
                                 + (["--device", *a] if a else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    if entry in ("tts", "server"):
        with pytest.raises(FileNotFoundError):   # past the device, on the CPU
            make("cpu")
    else:
        make("cpu")


_IMPORT_SERVING = """
import sys
BLOCKED = {blocked!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked " + name)

for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())
from cookietts_tpu_torch.pipeline import chunk_graph, server, streaming
assert callable(server.handle_tts) and callable(streaming.streaming_tts)
try:
    server.make_app(object())
except ImportError as e:
    print("make_app:", e)
"""


def test_streaming_and_server_import_without_jax_or_tornado():
    """The serving modules stand alone, and the server's module imports
    without tornado (which the card's machine lacks): only make_app and
    serve import it."""
    for name in ("chunk_graph.py", "streaming.py", "server.py"):
        assert PACKAGE / "pipeline" / name in set(PACKAGE.rglob("*.py"))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_SERVING.format(
            blocked=FORBIDDEN + ("tornado",))],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "make_app: blocked tornado" in proc.stdout


@pytest.mark.parametrize("entry", ["gmm", "dca", "train-heads"])
def test_attention_types_and_heads_training_raise_without_cuda(
        monkeypatch, tmp_path, entry):
    """A Tacotron2 of attention type 1 or 2, and the train command with the
    GST and EmotionNet heads, run on the card unless asked for the CPU."""
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "train-heads":
        args = ["train", "--filelist", str(tmp_path / "absent.txt"),
                "--run_dir", str(tmp_path),
                "--hparams", "use_gst=True,use_emotionnet=True"]
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(args)
        with pytest.raises(FileNotFoundError):      # past the device
            cli(args + ["--device", "cpu"])
        return
    cfg = Tacotron2Config(
        n_symbols=20, symbols_embedding_dim=8, n_speakers=2,
        speaker_embedding_dim=4, encoder_speaker_embed_dim=2,
        encoder_conv_hidden_dim=8, encoder_lstm_dim=8, torchmoji_dim=4,
        torchmoji_crushed_dim=2, memory_bottleneck_dim=8, prenet_dim=4,
        attention_rnn_dim=8, decoder_rnn_dim=8, second_decoder_rnn_dim=8,
        attention_dim=4, postnet_embedding_dim=8, num_att_mixtures=2,
        dynamic_filter_num=2, dynamic_filter_len=5,
        attention_type={"gmm": 1, "dca": 2}[entry])
    with pytest.raises(RuntimeError, match="CUDA"):
        Tacotron2(cfg)
    assert Tacotron2(cfg, device="cpu").device.type == "cpu"


_CONVERT_WITHOUT_JAX = """
import sys
BLOCKED = {blocked!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked " + name)

for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())
import torch
from cookietts_tpu_torch.cli import main
from cookietts_tpu_torch.models.torchmoji import TorchMoji
torch.save(TorchMoji(16, device="cpu").state_dict(), sys.argv[1] + "/tm.bin")
meta = main(["convert", "--model", "torchmoji", "--torch_ckpt",
             sys.argv[1] + "/tm.bin", "-o", sys.argv[1] + "/tm.pt"])
print(meta["model_config"]["nb_tokens"])
"""


def test_convert_command_runs_without_jax(tmp_path):
    """The convert command (convert/reference.py) reads and writes torch
    files with jax, flax and cookietts_tpu unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _CONVERT_WITHOUT_JAX.format(blocked=FORBIDDEN),
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "16"
    assert (tmp_path / "tm.pt").exists() and (tmp_path / "tm.pt.json").exists()


@pytest.mark.parametrize("cmd", ["export", "tts", "server"])
def test_artifact_commands_raise_without_cuda(monkeypatch, tmp_path, cmd):
    """``export``, ``tts --artifact`` and ``server --artifact`` run on the
    card unless given ``--device cpu`` (then they go on to read their
    files, missing here)."""
    from cookietts_tpu_torch.cli import main as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    argv = {"export": ["export", "--checkpoint", missing],
            "tts": ["tts", "--artifact", missing, "--text", "x"],
            "server": ["server", "--artifact", missing]}[cmd]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(argv)
    with pytest.raises(FileNotFoundError):
        cli(argv + ["--device", "cpu"])


_LOAD_ARTIFACT = """
import sys
sys.meta_path.insert(0, type("Block", (), {{"find_spec": staticmethod(
    lambda name, path=None, target=None: (_ for _ in ()).throw(ImportError(name))
    if name.split(".")[0] in {forbidden!r} else None)}})())
from cookietts_tpu_torch.runtime.export_serving import load_artifact
import torch
fns, meta = load_artifact({path!r}, "cpu")
audio = fns["vocoder_b1_t4"](torch.zeros(1, 4, 8))
models = sorted(m for m in sys.modules
                if m.startswith("cookietts_tpu_torch.models"))
print(tuple(audio.shape), models)
"""


def test_load_artifact_imports_no_model_module(tmp_path):
    """An artifact loads and runs in a process that imports nothing under
    cookietts_tpu_torch.models (nor jax): only the kernels' ops and the
    loader."""
    from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from cookietts_tpu_torch.runtime.export_serving import (
        export_vocoder_serving, save_artifact)
    gen = Generator(HiFiGANConfig(
        n_mel_channels=8, resblock_kernel_sizes=(3,), resblock_dilations=((1,),),
        upsample_rates=(2,), upsample_kernel_sizes=(4,),
        upsample_initial_channel=8), device="cpu")
    path = str(tmp_path / "voc.npz")
    save_artifact(path, export_vocoder_serving(
        lambda mel: gen(mel, infer=True), 8, [(1, 4)], device="cpu"),
        {"device": "cpu"})
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_ARTIFACT.format(forbidden=FORBIDDEN,
                                                     path=path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == "(1, 8) []"


@pytest.mark.parametrize("entry", ["gta", "train-gan_postnet",
                                   "train-hifigan_denoiser", "postnet",
                                   "denoiser", "critics"])
def test_gta_and_adversarial_trainers_raise_without_cuda(monkeypatch,
                                                         tmp_path, entry):
    """The gta command, the two new train commands and their models run on
    the card unless asked for the CPU (then the commands go on to read
    their missing files)."""
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.gan_postnet import (GANDiscriminator,
                                                        GANPostnet,
                                                        GANPostnetConfig)
    from cookietts_tpu_torch.models.hifigan_denoiser import (
        DenoiserWN, HiFiGANDenoiserConfig, MultiResSpect, SpectDiscriminator,
        WaveDiscriminator)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.txt")
    if entry == "gta" or entry.startswith("train"):
        argv = (["gta", "--checkpoint", missing, "--filelist", missing]
                if entry == "gta" else
                ["train", "--model", entry.split("-")[1], "--filelist",
                 missing, "--run_dir", str(tmp_path / "run")])
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(argv)
        with pytest.raises(FileNotFoundError):      # past the device
            cli(argv + ["--device", "cpu"])
        return
    pcfg = GANPostnetConfig(n_mel_channels=4, speaker_embedding_dim=2,
                            noise_dim=2, n_convolutions=2, embedding_dim=4)
    dcfg = HiFiGANDenoiserConfig(
        wn_layers=1, wn_channels=4, wn_dilations=None, postnet_layers=1,
        postnet_channels=4, postnet_kernel_size=4, window_lengths=(32,),
        hop_lengths=(8,), dw_n_discriminators=1, dw_kernel_sizes=(3,),
        dw_strides=(1,), dw_channels=(1,), dw_group_sizes=(1,),
        ds_block_confs=((2, 3, 1, 1, 2),))
    make = {"postnet": [lambda *a: GANPostnet(pcfg, *a),
                        lambda *a: GANDiscriminator(pcfg, *a)],
            "denoiser": [lambda *a: DenoiserWN(dcfg, *a),
                         lambda *a: MultiResSpect((32,), (8,), *a)],
            "critics": [lambda *a: WaveDiscriminator(dcfg, *a),
                        lambda *a: SpectDiscriminator(dcfg, *a)]}[entry]
    for build in make:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        build("cpu")


@pytest.mark.parametrize("entry", ["command", "run_preprocess", "dump",
                                   "frontend"])
def test_preprocess_raises_without_cuda(monkeypatch, tmp_path, entry):
    """The preprocess command, run_preprocess, the feature dump and the
    fused frontend run on the card unless asked for the CPU (then the
    command goes on to read its missing config)."""
    from cookietts_tpu_torch.audio.features import fused_frontend
    from cookietts_tpu_torch.audio.stft import TacotronSTFT
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.pipeline.preprocess import (
        PreprocessConfig, dump_features_on_device, run_preprocess)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.json")
    cfg = PreprocessConfig(out_dir=str(tmp_path / "out"))
    make = {"command": lambda *a: cli(["preprocess", "-c", missing]
                                      + (["--device", *a] if a else [])),
            "run_preprocess": lambda *a: run_preprocess(cfg, None, *a),
            "dump": lambda *a: dump_features_on_device([], cfg, *a),
            "frontend": lambda *a: fused_frontend(
                TacotronSTFT(256, 64, 256, 8, device="cpu"), sr=22050,
                device=(a or ("cuda",))[0])}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    if entry == "command":
        with pytest.raises(FileNotFoundError):     # past the device
            make("cpu")
    else:
        make("cpu")
