"""The port's GTA stage (pipeline/gta.py and the ``gta`` command) against the
JAX package's, on the CPU.

A tiny JAX Tacotron2 (random weights, perturbed BatchNorm statistics,
zoneout and LSTM dropout on, which eval form must skip; prenet dropout 0,
since JAX's threefry and torch never draw the same masks) is carried across
with ``convert.from_jax.tacotron2_state_dict_from_jax``. The corpus is four
utterances of ``data/evidence_corpus.py`` at its 22050 Hz recipe with 80
mels, collated by the port into one 160-frame bucket. JAX's
``GTAGenerator._fn`` runs once on all four; the port runs them as a batch of
3 and a short batch of 1. Tolerances: mels and alignments 1e-4 absolute;
the numpy helpers and the written letter durations exactly.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cookietts_tpu.data.dataset import DataConfig as JDataConfig
from cookietts_tpu.data.dataset import TTSDataset as JTTSDataset
from cookietts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from cookietts_tpu.models.tacotron2 import Tacotron2Config as JConfig
from cookietts_tpu.pipeline import gta as J
from cookietts_tpu.text import N_SYMBOLS
from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.convert.from_jax import tacotron2_state_dict_from_jax
from cookietts_tpu_torch.data.dataset import DataConfig, TTSDataset, collate
from cookietts_tpu_torch.data.evidence_corpus import make_corpus
from cookietts_tpu_torch.data.filelist import load_filelist
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.pipeline import gta as P
from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
from test_torch_threads import _one_thread  # noqa: F401


TINY = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16,
    encoder_n_convolutions=2, torchmoji_dim=8, torchmoji_crushed_dim=4,
    memory_bottleneck_dim=16, prenet_dim=8, attention_rnn_dim=16,
    decoder_rnn_dim=16, second_decoder_rnn_dim=16, attention_dim=8,
    windowed_attention_range=2, postnet_embedding_dim=16,
    postnet_n_convolutions=3, postnet_residual_connections=2,
    p_prenet_dropout=0.0, attrnn_zoneout=0.1, decrnn_zoneout=0.1,
    p_attrnn_dropout=0.1, p_decrnn_dropout=0.1)
DATA = dict(sampling_rate=22050, filter_length=1024, hop_length=256,
            win_length=1024, n_mel_channels=80, mel_fmax=8000.0,
            trim_enable=False, p_arpabet=0.0, text_buckets=(32,),
            mel_buckets=(160,))
HPARAMS = ",".join(f"{k}={list(v) if isinstance(v, tuple) else v}"
                   for k, v in DATA.items()).replace(" ", "")
ATOL = 1e-4


def _perturb(variables, rng):
    v = jax.tree_util.tree_map(np.array, variables)
    for path, x in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]:
        name = jax.tree_util.keystr(path)
        x[...] = (rng.uniform(0.5, 1.5, x.shape) if "var" in name
                  else rng.normal(0, 0.2, x.shape))
    return v


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    """The corpus, the port's collated batch of all four utterances, JAX's
    GTA generator over it (mels, alignments), and the port's model."""
    root = tmp_path_factory.mktemp("gta")
    train_fl, _ = make_corpus(str(root / "corpus"), seed=0, n_train=4,
                              n_val=0)
    dcfg = DataConfig(**DATA)
    ds = TTSDataset(load_filelist(train_fl), dcfg)
    batch = collate([ds[i] for i in range(4)], dcfg)
    assert batch["mels"].shape[1] == 160 and batch["text"].shape[1] == 32

    jm = JTacotron2(JConfig(**TINY))
    rng = np.random.default_rng(0)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                text=jnp.asarray(batch["text"][:1]),
                text_lengths=jnp.asarray(batch["text_lengths"][:1]),
                mels=jnp.zeros((1, 16, 80)), mel_lengths=jnp.full((1,), 16),
                speaker_id=jnp.zeros((1,), jnp.int32),
                sylps=jnp.full((1,), 4.0), key=jax.random.PRNGKey(2),
                deterministic=True)
    v = _perturb(v, rng)
    jgen = J.GTAGenerator(jm, v, str(root / "jax_out"), hop_length=256)
    dev = {k: jnp.asarray(x) for k, x in batch.items() if k != "audiopath"}
    mels, aligns = jgen._fn(v, dev, jax.random.PRNGKey(0))
    model = Tacotron2(Tacotron2Config(**TINY), device="cpu")
    model.load_state_dict(tacotron2_state_dict_from_jax(v["params"],
                                                        v["batch_stats"]))
    ckpt = str(root / "taco.pt")
    save_checkpoint(ckpt, {"step": 0, "state_dict": model.state_dict()},
                    {"model": "tacotron2", "model_config": TINY})
    return dict(root=root, train_fl=train_fl, dcfg=dcfg, ds=ds, batch=batch,
                jgen=jgen, mels=np.asarray(mels), aligns=np.asarray(aligns),
                model=model, ckpt=ckpt)


def _rows(batch, sl):
    return {k: v[sl] for k, v in batch.items()}


@pytest.mark.parametrize("rows", [slice(0, 3), slice(3, 4)],
                         ids=["batch3", "short1"])
def test_forward_matches_jax(side, rows):
    """Eval form at full teacher forcing: the postnet mels and alignments
    of a batch of 3 and of the short last batch against JAX's rows."""
    gen = P.GTAGenerator(side["model"], str(side["root"] / "p_out"))
    mels, aligns = gen.forward(_rows(side["batch"], rows))
    assert not side["model"].training
    assert gen.decoder_steps == 160
    np.testing.assert_allclose(mels.numpy(), side["mels"][rows], atol=ATOL)
    np.testing.assert_allclose(aligns.numpy(), side["aligns"][rows],
                               atol=ATOL)


@pytest.mark.parametrize("helper", ["durations", "offsets", "offset_mels"])
def test_numpy_helpers_match_jax(side, helper):
    b = side["batch"]
    if helper == "durations":
        want = J.durations_from_alignment(side["aligns"], b["text_lengths"],
                                          b["mel_lengths"])
        got = P.durations_from_alignment(side["aligns"], b["text_lengths"],
                                         b["mel_lengths"])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    elif helper == "offsets":
        for hop, step in ((256, 64), (256, 256), (600, 150)):
            assert P.extreme_gta_offsets(hop, step) == \
                J.extreme_gta_offsets(hop, step)
        with pytest.raises(AssertionError):
            P.extreme_gta_offsets(256, 100)
    else:
        jds = JTTSDataset(load_filelist(side["train_fl"]),
                          JDataConfig(**DATA))
        items = [side["ds"][i] for i in range(2)]
        jitems = [jds[i] for i in range(2)]
        for offset in (0, 128):
            got = P.offset_item_mels(side["ds"], items, offset)
            want = J.offset_item_mels(jds, jitems, offset)
            for g, w in zip(got, want):
                assert g["mel_length"] == w["mel_length"]
                np.testing.assert_allclose(g["mel"], w["mel"], atol=1e-4)


def test_process_batch_writes_jax_layout(side, tmp_path):
    """process_batch at offset 0 and at an extremeGTA offset, and write_map:
    JAX's file names and map lines (paths aside), its mels (1e-4) and
    letter durations (exact)."""
    b, out = side["batch"], {}
    for name, gen in (("jax", side["jgen"]),
                      ("port", P.GTAGenerator(side["model"],
                                              str(tmp_path / "port_out")))):
        d = tmp_path / name
        d.mkdir()
        paths = [str(d / p.rsplit("/", 1)[1]) for p in b["audiopath"]]
        batch = {k: v for k, v in b.items() if k != "audiopath"}
        lines = (gen.process_batch(batch, paths)
                 + gen.process_batch(batch, paths, offset=128))
        gen.outdir = str(d)
        map_path = gen.write_map(lines)
        out[name] = (d, [ln.replace(str(d), "") for ln in lines],
                     open(map_path).read().replace(str(d), ""))
    (jd, jlines, jmap), (pd, plines, pmap) = out["jax"], out["port"]
    assert plines == jlines and pmap == jmap and len(plines) == 8
    names = sorted(p.name for p in pd.iterdir())
    assert names == sorted(p.name for p in jd.iterdir())
    assert "map_train_0.txt" in names
    assert {n.split(".wav")[1] for n in names if ".wav" in n} == {
        ".mel.npy", ".mel128.npy", ".gdur.npy", ".gdur128.npy"}
    for n in names:
        if n.endswith(".txt"):
            continue
        got, want = np.load(pd / n), np.load(jd / n)
        assert got.shape == want.shape and got.dtype == want.dtype, n
        if ".gdur" in n:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("extreme", [0, 128], ids=["plain", "extremeGTA"])
def test_gta_command(side, tmp_path, extreme):
    """``gta --device cpu`` on the 4-utterance corpus at batch 3 (a short
    last batch): one map line per utterance (and offset), finite mels of
    [T, 80] whose letter durations sum to T, the stats line."""
    corpus = tmp_path / "corpus"
    shutil.copytree(side["root"] / "corpus", corpus)
    fl = tmp_path / "filelist.txt"
    fl.write_text(open(side["train_fl"]).read().replace(
        str(side["root"] / "corpus"), str(corpus)))
    out = tmp_path / "out"
    stats = cli(["gta", "--device", "cpu", "--checkpoint", side["ckpt"],
                 "--filelist", str(fl), "-o", str(out), "--batch_size", "3",
                 "--hparams", HPARAMS]
                + (["--extremeGTA", str(extreme)] if extreme else []))
    lines = (out / "map_train_0.txt").read_text().splitlines()
    offsets = [0, 128] if extreme else [0]
    assert len(lines) == stats["utterances"] == 4 * len(offsets)
    assert stats["decoder_steps"] == 2 * 160 * len(offsets)
    assert stats["kernel_launches"] == {k: 0 for k in
                                        stats["kernel_launches"]}
    for ln in lines:
        wav, mel_path, spk = ln.split("|")
        assert spk == "0" and mel_path.startswith(wav + ".mel")
        mel = np.load(mel_path)
        assert mel.ndim == 2 and mel.shape[1] == 80
        assert np.isfinite(mel).all()
        dur = np.load(mel_path.replace(".mel", ".gdur"))
        assert dur.sum() == mel.shape[0]
    assert json.dumps(stats)
