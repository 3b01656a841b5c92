"""Data-parallel training across processes (cookietts_tpu_torch/parallel/)
on the CPU: two gloo ranks against one process on the same global batches,
and against JAX's loss on that batch.

One 2-rank run serves the module: the file starts itself twice with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and a
free MASTER_PORT), so ``parallel.initialize()`` runs as it does under
torchrun, and each rank saves what it computed into the run's directory.
While the ranks run, this process computes the one-process runs and JAX's
loss. Checked:

- ``global_bucket_shapes`` / ``collate_local_shard`` against JAX's on the
  synthetic corpus, ``global_batch_slice`` at each rank;
- three Tacotron2 train steps on a global batch of 4 whose rank 0 holds
  long utterances and rank 1 short ones (dropout 0, teacher forcing 1,
  SylpsNet's eps JAX's; the weights seeded, carried to JAX by its converter
  of the reference layout): every loss term within rel 1e-5 of one process's,
  the parameters, Adam moments and BatchNorm statistics within atol 1e-6 /
  rtol 1e-4, the first step's loss terms within rel 1e-5 of JAX's; the
  same steps with local means averaged across ranks (DDP's rule) miss;
- one HiFi-GAN and one GAN-postnet iteration (D then G) at 2 ranks against
  one process;
- the train command: Tacotron2 at 2 ranks (dropouts on) against one
  process, per-iteration losses, with one writer; GAN-TTS resumed at 2
  ranks against the uninterrupted run and one process; a Tacotron2 Trainer
  resumed at 2 ranks against the uninterrupted one;
- the refusals at world 2: untts, waveglow, a batch that does not divide.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.device import batch_to_device
from cookietts_tpu_torch.losses import DEFAULT_LOSS_SCALARS
from cookietts_tpu_torch.models.gan_postnet import (GANDiscriminator,
                                                    GANPostnet,
                                                    GANPostnetConfig)
from cookietts_tpu_torch.models.hifigan import (Generator, HiFiGANConfig,
                                                MultiPeriodDiscriminator,
                                                MultiScaleDiscriminator)
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.parallel import (SINGLE, DataParallel,
                                          allgather_object, draw_rows,
                                          global_batch_slice, initialize)
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
from cookietts_tpu_torch.runtime.trainer import (
    Trainer, TrainerConfig, gan_postnet_noise, make_gan_postnet_train_steps,
    make_gan_trainer_step, make_hifigan_train_steps,
    make_tacotron2_train_step)
from cookietts_tpu_torch.text import N_SYMBOLS
from test_torch_threads import _one_thread  # noqa: F401
from torch_ranks import RANK_TIMEOUT, Ranks

WORLD = 2
LOSS_RTOL, ATOL, RTOL = 1e-5, 1e-6, 1e-4

# Tacotron2 for the steps: nothing drawn but SylpsNet's eps (given)
TACO = dict(
    symbols_embedding_dim=16, n_speakers=4, speaker_embedding_dim=8,
    encoder_speaker_embed_dim=4, encoder_conv_hidden_dim=16,
    encoder_lstm_dim=16, encoder_n_convolutions=2, torchmoji_dim=8,
    torchmoji_crushed_dim=4, memory_bottleneck_dim=16, prenet_dim=8,
    attention_rnn_dim=16, decoder_rnn_dim=16, second_decoder_rnn_dim=16,
    attention_dim=8, windowed_attention_range=2, postnet_embedding_dim=16,
    postnet_n_convolutions=3, postnet_residual_connections=2,
    p_prenet_dropout=0.0, encoder_conv_dropout=0.0, p_attrnn_dropout=0.0,
    p_decrnn_dropout=0.0, use_postnet=False)
B, T_TXT, T_DEC, M = 4, 12, 10, 80
MEL_LENGTHS = np.array([10, 9, 3, 2])       # rank 0 long, rank 1 short
TEXT_LENGTHS = np.array([12, 11, 4, 3])
CTRL = {"lr": 1e-3, "grad_clip": 1.0, "p_teacher_forcing": 1.0,
        "teacher_force_till": 0, "drop_frame_rate": 0.0,
        "guided_att_sigma": 0.5, **DEFAULT_LOSS_SCALARS}
# the global batch's rows in another order: the ranks' blocks swapped
SWAP = [2, 3, 0, 1]
TERMS = ("loss", "spec_MSE", "spec_MFSE", "postnet_MSE", "postnet_MFSE",
         "gate_loss", "sylps_kld", "sylps_MSE", "sylps_MAE", "diag_att")

# the train command's tiny Tacotron2 (dropouts and the postnet on)
CLI_TACO = {k: v for k, v in TACO.items()
            if not k.startswith("p_") and k not in ("encoder_conv_dropout",
                                                     "use_postnet")}
TACO_FRONT = ("sampling_rate=22050,filter_length=1024,hop_length=256,"
              "win_length=1024,mel_fmax=8000.0,trim_enable=False,"
              "mel_buckets=[64],max_segment_frames=64,batch_size=4,"
              "log_every=1,validation_interval=2,checkpoint_interval=2,"
              "curation_enable=False")
HIFIGAN = dict(n_mel_channels=16, resblock_kernel_sizes=(3,),
               resblock_dilations=((1, 3),), upsample_rates=(4, 4, 8),
               upsample_kernel_sizes=(8, 8, 16), upsample_initial_channel=16,
               mpd_periods=(2,), msd_scales=1)
GANTTS_FRONT = ("sampling_rate=22050,filter_length=512,hop_length=128,"
                "win_length=512,n_mel_channels=20,mel_fmax=8000.0,"
                "trim_enable=False,text_buckets=[16],mel_buckets=[192],"
                "batch_size=4,validation_interval=2,checkpoint_interval=2,"
                "log_every=1,symbols_embedding_dim=16,n_speakers=4,"
                "speaker_embedding_dim=8,enc_layers=1,enc_heads=2,"
                "enc_ffn_dim=24,z_dim=8,g_channels=[16,16],d_channels=[8,8],"
                "d_windows=[8,16],mel_weight=2.0,d_lr_scale=0.5")
POSTNET = dict(n_mel_channels=8, speaker_embedding_dim=4, noise_dim=4,
               n_convolutions=3, embedding_dim=12, residual_connections=2)


def _hparams(front, cfg):
    text = lambda v: str(list(v)).replace(" ", "") if isinstance(  # noqa: E731
        v, tuple) else str(v)
    return front + "," + ",".join(f"{k}={text(v)}" for k, v in cfg.items())


def taco_batch():
    """The global batch: rows 0-1 long, rows 2-3 short."""
    rng = np.random.default_rng(0)
    valid = np.arange(T_DEC)[None, :, None] < MEL_LENGTHS[:, None, None]
    return dict(
        text=rng.integers(1, N_SYMBOLS, (B, T_TXT)), text_lengths=TEXT_LENGTHS,
        mels=(rng.normal(0, 1, (B, T_DEC, M)) * valid).astype(np.float32),
        mel_lengths=MEL_LENGTHS, speaker_id=np.array([1, 3, 0, 2]),
        sylps=np.array([3.0, 4.5, 5.0, 3.5], np.float32),
        torchmoji=rng.normal(0, 1, (B, 8)).astype(np.float32),
        gate_target=(np.arange(T_DEC)[None] >= MEL_LENGTHS[:, None] - 1
                     ).astype(np.float32),
        pres_prev_state=np.zeros(B, np.float32),
        global_mean=rng.normal(0, 1, M).astype(np.float32))


def reorder(batch, order):
    """The batch's rows in ``order`` (None: as they are)."""
    if order is None:
        return batch
    return {k: v if k == "global_mean" else np.asarray(v)[order]
            for k, v in batch.items()}


def _state_of(state):
    """Parameters, Adam moments and buffers on the CPU, by name."""
    sides = [state.g, state.d] if hasattr(state, "d") else [state]
    out = {}
    for i, side in enumerate(sides):
        for k, v in side.model.state_dict().items():
            out[f"{i}.{k}"] = v.detach().clone()
        for k in side.opt_state.mu:
            out[f"{i}.mu.{k}"] = side.opt_state.mu[k].clone()
            out[f"{i}.nu.{k}"] = side.opt_state.nu[k].clone()
    return out


def taco_steps(inputs, dp, steps=3, order=None):
    """``steps`` train steps from the given weights on (this rank's rows
    of) the global batch, its rows in ``order`` -> (loss dicts, state)."""
    model = Tacotron2(Tacotron2Config(n_symbols=N_SYMBOLS, **TACO),
                      device="cpu")
    model.load_state_dict(inputs["state_dict"])
    state = TrainState.create(model, adam())
    step = make_tacotron2_train_step(model, dp=dp)
    batch = reorder(dict(inputs["batch"], sylps_noise=inputs["eps"]), order)
    dev = batch_to_device((dp or SINGLE).shard_batch(batch), "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(steps):
        _, ld, _, _ = step(state, dev, gen, CTRL)
        losses.append({k: float(v) for k, v in ld.items()})
    return losses, _state_of(state)


def hifigan_iteration(dp, order=None):
    """One D and one G step of a tiny HiFi-GAN on a global batch of 4."""
    from cookietts_tpu_torch.audio.stft import TacotronSTFT
    torch.manual_seed(0)
    cfg = HiFiGANConfig(**HIFIGAN)
    gen = Generator(cfg, device="cpu", weight_norm=True)
    disc = torch.nn.ModuleDict({
        "mpd": MultiPeriodDiscriminator(cfg, device="cpu"),
        "msd": MultiScaleDiscriminator(cfg, device="cpu")})
    mel_fn = TacotronSTFT(512, 128, 512, 16, 16000, 0.0, 8000.0,
                          device="cpu").mel_spectrogram
    step = make_gan_trainer_step(*make_hifigan_train_steps(
        gen, disc["mpd"], disc["msd"], mel_fn, dp=dp), dp=dp)
    state = GANTrainState(TrainState.create(gen, adam(weight_decay=0.01)),
                          TrainState.create(disc, adam(weight_decay=0.01)))
    rng = np.random.default_rng(1)
    t = np.arange(2048) / 16000
    batch = {"mels": rng.normal(-5, 1.5, (4, 16, 16)).astype(np.float32),
             "audio": (0.3 * np.sin(2 * np.pi * 220 * np.outer([1, 2, 3, 4],
                                                               t))
                       + 0.05 * rng.standard_normal((4, 2048))
                       ).astype(np.float32)}
    batch = batch_to_device((dp or SINGLE).shard_batch(reorder(batch, order)),
                            "cpu")
    _, metrics = step(state, batch, None, {"lr": 1e-4, "grad_clip": 1.0})
    return {k: float(v) for k, v in metrics.items()}, _state_of(state)


def postnet_iteration(dp, order=None):
    """One D and one G step of a tiny GAN postnet on a global batch of 4
    whose ranks differ in valid frames (the mel MSE's mask); the noise is
    the batch's, so it moves with the rows. D's learning rate is 0: the
    gradient of a conv bias ahead of D's BatchNorm is rounding noise, which
    Adam's normalised step turns into +-lr, and the G step reads D in eval
    form, where that bias moves the output; D's step is held through its
    moments and BatchNorm statistics."""
    torch.manual_seed(0)
    cfg = GANPostnetConfig(**POSTNET)
    post, disc = GANPostnet(cfg, "cpu"), GANDiscriminator(cfg, "cpu")
    step = make_gan_trainer_step(
        *make_gan_postnet_train_steps(post, disc, dp=dp), d_lr_scale=0.0,
        prepare=gan_postnet_noise(cfg.noise_dim), dp=dp)
    state = GANTrainState(TrainState.create(post, adam()),
                          TrainState.create(disc, adam()))
    rng = np.random.default_rng(2)
    T = 12
    batch = {"decoder_mel": rng.normal(0, 1, (4, T, 8)).astype(np.float32),
             "gt_mel": rng.normal(0, 1, (4, T, 8)).astype(np.float32),
             "speaker_embed": rng.normal(0, 1, (4, 4)).astype(np.float32),
             "mel_mask": (np.arange(T)[None] < np.array([12, 11, 4, 2])[:, None]
                          ).astype(np.float32),
             "noise": rng.normal(0, 1, (4, T, 4)).astype(np.float32)}
    batch = batch_to_device((dp or SINGLE).shard_batch(reorder(batch, order)),
                            "cpu")
    _, metrics = step(state, batch, None, {"lr": 1e-3, "grad_clip": 10.0})
    return {k: float(v) for k, v in metrics.items()}, _state_of(state)


def trainer_batches(n=4):
    """Global Tacotron2 batches of 4 (the audio paths for curation)."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        ml = rng.integers(5, T_DEC + 1, B)
        valid = np.arange(T_DEC)[None, :, None] < ml[:, None, None]
        out.append(dict(
            text=rng.integers(1, N_SYMBOLS, (B, 9)),
            text_lengths=rng.integers(4, 10, B),
            mels=(rng.normal(-4, 1, (B, T_DEC, M)) * valid).astype(np.float32),
            mel_lengths=ml, speaker_id=rng.integers(0, 4, B),
            sylps=rng.uniform(3, 6, B).astype(np.float32),
            gate_target=(np.arange(T_DEC)[None] >= ml[:, None] - 1).astype(
                np.float32),
            pres_prev_state=np.zeros(B, np.float32),
            global_mean=np.full(M, -4.0, np.float32),
            audiopath=[f"u{i}_{j}.wav" for j in range(B)]))
    return out


def resumed_trainer_diff(out, dp):
    """4 Trainer iterations straight through against 2, a save and a fresh
    Trainer (other weights) resumed for the last 2, at 2 ranks, dropouts
    on: the largest difference of any parameter, moment or buffer."""
    def trainer(run, seed):
        torch.manual_seed(seed)
        model = Tacotron2(Tacotron2Config(n_symbols=N_SYMBOLS, **CLI_TACO),
                          device="cpu")
        t = Trainer(TrainerConfig(run_dir=os.path.join(out, run), seed=7),
                    TrainState.create(model, adam()),
                    make_tacotron2_train_step(model, dp=dp), device="cpu",
                    dp=dp)
        t.live.values.update(validation_interval=0, checkpoint_interval=0,
                             drop_frame_rate=0.5)
        return t
    batches = [dp.shard_batch(b) for b in trainer_batches()]
    a = trainer("straight", 0)
    for b in batches:
        a.step(b)
    r = trainer("resumed", 0)
    for b in batches[:2]:
        r.step(b)
    r.save(periodic=True)
    r = trainer("resumed", 1)
    assert r.resume() == 2
    for b in batches[2:]:
        r.step(b)
    sa, sr = _state_of(a.state), _state_of(r.state)
    return max(float((sa[k].float() - sr[k].float()).abs().max()) for k in sa)


def taco_cli_args(corpus, run):
    return ["train", "--device", "cpu", "--filelist", corpus, "--run_dir",
            run, "--seed", "3", "--iters", "3", "--hparams",
            _hparams(TACO_FRONT, CLI_TACO)]


def gantts_cli_args(corpus, run, iters, resume=False):
    return (["train", "--model", "gantts", "--device", "cpu", "--filelist",
             corpus, "--run_dir", run, "--seed", "2", "--iters", str(iters),
             "--hparams", GANTTS_FRONT] + (["--resume"] if resume else []))


class LocalMeans(DataParallel):
    """DDP's rule, the negative control: each rank's loss terms over its
    own rows, averaged, and BatchNorm over its own rows."""

    def denominator(self, den):
        return den * self.size

    def batch_moments(self, sums, count):
        return sums / float(count)


def refusal(argv):
    try:
        cli(argv)
    except SystemExit as e:
        return str(e)
    return None


def worker(out):
    """One rank of the module's run (started with torchrun's environment)."""
    torch.set_num_threads(1)
    import cookietts_tpu_torch.runtime.checkpoint as ckpt
    assert initialize("cpu", timeout=RANK_TIMEOUT)
    dp = DataParallel()
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    res = {"rank": dp.rank, "slice": global_batch_slice(8)}
    try:
        global_batch_slice(7)
    except ValueError as e:
        res["slice_error"] = str(e)
    res["gathered"] = allgather_object({"rank": dp.rank})
    res["taco"] = taco_steps(inputs, dp)
    res["taco_local"] = taco_steps(inputs, LocalMeans())
    res["hifigan"] = hifigan_iteration(dp)
    res["postnet"] = postnet_iteration(dp)

    saves = []
    real_save = ckpt.save_checkpoint
    ckpt.save_checkpoint = lambda path, *a, **k: (saves.append(path),
                                                  real_save(path, *a, **k))
    trainer = cli(taco_cli_args(inputs["corpus"], os.path.join(out, "taco")))
    res["taco_cli"] = {"saves": list(saves), "steps": int(trainer.state.step),
                       "logger_writes": trainer.logger._jsonl is not None}
    saves.clear()
    cli(gantts_cli_args(inputs["corpus"], os.path.join(out, "gantts"), 4))
    cli(gantts_cli_args(inputs["corpus"], os.path.join(out, "gantts_r"), 2))
    trainer = cli(gantts_cli_args(inputs["corpus"],
                                  os.path.join(out, "gantts_r"), 4, True))
    res["vocoder_cli"] = {"saves": list(saves),
                          "steps": int(trainer.state.step)}
    ckpt.save_checkpoint = real_save
    res["trainer_resume_diff"] = resumed_trainer_diff(out, dp)

    res["refusals"] = {
        "untts": refusal(["train", "--model", "untts", "--device", "cpu",
                          "--filelist", inputs["corpus"], "--run_dir",
                          os.path.join(out, "untts")]),
        "waveglow": refusal(["train", "--model", "waveglow", "--device",
                             "cpu", "--filelist", inputs["corpus"],
                             "--run_dir", os.path.join(out, "waveglow")]),
        "batch": refusal(taco_cli_args(inputs["corpus"],
                                       os.path.join(out, "odd"))[:-1]
                         + [_hparams(TACO_FRONT.replace("batch_size=4",
                                                        "batch_size=3"),
                                     CLI_TACO)])}
    torch.save(res, os.path.join(out, f"rank{dp.rank}.pt"))
    dp.barrier()


# -- the module's run ------------------------------------------------------------

JAX_KEY = 5


def taco_weights():
    """Seeded weights of the tiny Tacotron2, with running statistics away
    from their initial values."""
    torch.manual_seed(0)
    model = Tacotron2(Tacotron2Config(n_symbols=N_SYMBOLS, **TACO),
                      device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for k, v in model.named_buffers():
            if "running" in k:
                v.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    return model.state_dict()


def jax_sylps_eps():
    """SylpsNet's eps as JAX's Tacotron2 draws it from ``JAX_KEY``."""
    import jax
    _, k_mem, _, _ = jax.random.split(jax.random.PRNGKey(JAX_KEY), 4)
    return np.asarray(jax.random.normal(jax.random.split(k_mem)[1], (B,)))


def jax_loss_terms(state_dict, batch):
    """JAX's Tacotron2 in training form on the global batch, from the same
    weights (JAX's converter of the reference layout, which the port's
    state dict keeps): its loss terms."""
    import jax
    import jax.numpy as jnp
    from cookietts_tpu.convert import convert_tacotron2_state_dict
    from cookietts_tpu.losses import tacotron2_loss as jax_loss
    from cookietts_tpu.models.tacotron2 import (Tacotron2 as JTacotron2,
                                               Tacotron2Config as JConfig)
    params, stats = convert_tacotron2_state_dict(
        {k: v.numpy() for k, v in state_dict.items()})
    jm = JTacotron2(JConfig(n_symbols=N_SYMBOLS, **TACO))
    v = {"params": params, "batch_stats": stats}

    @jax.jit
    def terms(v, batch):
        carry = jm.apply(v, B, T_TXT, TACO["memory_bottleneck_dim"],
                         jnp.float32,
                         method=lambda m, *a: m.decoder.init_carry(*a))
        (out, _), _ = jm.apply(
            v, text=batch["text"], text_lengths=batch["text_lengths"],
            mels=batch["mels"], mel_lengths=batch["mel_lengths"],
            speaker_id=batch["speaker_id"], sylps=batch["sylps"],
            torchmoji_hidden=batch["torchmoji"],
            key=jax.random.PRNGKey(JAX_KEY), p_teacher_forcing=1.0,
            teacher_force_till=0, drop_frame_rate=0.0,
            global_mean=batch["global_mean"], deterministic=False,
            init_carry=carry, pres_prev_state=batch["pres_prev_state"],
            rngs={"dropout": jax.random.PRNGKey(9)}, mutable=["batch_stats"])
        gt = {k: batch[k] for k in ("mels", "mel_lengths", "text_lengths",
                                    "sylps", "gate_target", "pres_prev_state")}
        return jax_loss(out, gt)[1]

    ld = terms(v, batch)
    return {k: float(ld[k]) for k in TERMS if k in ld}


def _jax_shards(corpus):
    """(port, JAX) local shards of one TBPTT batch of 4 at each rank, and
    the global widths, on the synthetic corpus."""
    from cookietts_tpu.data import dataset as J
    from cookietts_tpu_torch.data import dataset as P
    from cookietts_tpu_torch.data.filelist import load_filelist
    hp = dict(sampling_rate=22050, filter_length=1024, hop_length=256,
              win_length=1024, mel_fmax=8000.0, trim_enable=False,
              mel_buckets=(64,), max_segment_frames=64)
    entries = load_filelist(corpus)
    feats = ["text", "mel", "speaker_id", "sylps", "gate"]
    pds = P.TTSDataset(entries, P.DataConfig(**hp), features=feats)
    jds = J.TTSDataset(entries, J.DataConfig(**hp), features=feats)
    segs = next(iter(P.TBPTTSampler(pds.mel_frame_lengths(), 4, 64, seed=0)))
    jsegs = [J.Segment(s.file_idx, s.seg_idx, s.n_segs) for s in segs]
    shapes = (P.global_bucket_shapes(pds, segs, pds.cfg),
              J.global_bucket_shapes(jds, jsegs, jds.cfg))
    shards = [(P.collate_local_shard(pds, segs, pds.cfg, r, WORLD),
               J.collate_local_shard(jds, jsegs, jds.cfg, r, WORLD))
              for r in range(WORLD)]
    return shapes, shards


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2-rank run and, meanwhile, the one-process runs and JAX."""
    from cookietts_tpu_torch.data.evidence_corpus import make_corpus
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = str(tmp_path_factory.mktemp("dp"))
    batch = taco_batch()
    corpus = make_corpus(os.path.join(out, "corpus"), seed=0, n_train=8,
                         n_val=4)[0]
    inputs = {"batch": batch, "eps": jax_sylps_eps(),
              "state_dict": taco_weights(),
              "corpus": corpus}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    ranks = Ranks(__file__, out, WORLD)
    try:
        one = {"jax": jax_loss_terms(inputs["state_dict"], batch),
               "shards": _jax_shards(corpus),
               "hifigan": hifigan_iteration(None)}
        for order, suffix in ((None, ""), (SWAP, "_swap")):
            one["taco" + suffix] = taco_steps(inputs, None, order=order)
            one["postnet" + suffix] = postnet_iteration(None, order)
        cli(taco_cli_args(corpus, os.path.join(out, "taco1")))
        cli(gantts_cli_args(corpus, os.path.join(out, "gantts1"), 4))
        ranks.wait()
    finally:
        ranks.close()
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return dict(out=out, one=one, ranks=ranks)


def _events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _violations(got, want, twin, atol, rtol, free=0.0):
    """Where |got - want| exceeds atol + rtol |want|, 10 times what
    reordering the global batch's rows moves the one-process value
    (|want - twin|: Adam's first steps normalise each gradient element, so
    an element whose gradient is rounding noise moves by up to lr either
    way whatever the summation order), and ``free``."""
    got, want, twin = (np.asarray(x, np.float64) for x in (got, want, twin))
    allowed = np.maximum(atol + rtol * np.abs(want), 10 * np.abs(want - twin))
    return np.abs(got - want) > np.maximum(allowed, free)


def _hold_losses(got, want, twin):
    for k in want:
        bad = _violations(got[k], want[k], twin[k], 1e-7, LOSS_RTOL)
        assert not bad.any(), (k, got[k], want[k], twin[k])


def _state_misses(got, want, twin, lr_steps):
    """The entries (parameters, Adam moments, buffers) that miss. A
    parameter element whose gradient is within the moments' tolerance of
    zero (|mu| <= 1e-6: the conv biases ahead of a training-form
    BatchNorm, whose gradient is zero but for rounding, and sums that
    cancel) may take Adam's normalised step either way: within 2 lr a step
    (``lr_steps``: lr times the steps)."""
    assert set(got) == set(want)
    misses = []
    for k in want:
        side, _, name = k.partition(".")
        mu = want.get(f"{side}.mu.{name}")
        free = 0.0 if mu is None else np.where(mu.abs().numpy() <= ATOL,
                                               2 * lr_steps, 0.0)
        if _violations(got[k].numpy(), want[k].numpy(), twin[k].numpy(),
                       ATOL, RTOL, free).any():
            misses.append(k)
    return misses


def _hold_states(got, want, twin, lr_steps):
    misses = _state_misses(got, want, twin, lr_steps)
    assert not misses, [
        (k, float((got[k] - want[k]).abs().max())) for k in misses]


# -- the tests ------------------------------------------------------------------

def test_local_shards_and_global_widths_match_jax(run):
    (p_shape, j_shape), shards = run["one"]["shards"]
    assert p_shape == j_shape
    for p, j in shards:
        assert set(p) == set(j)
        for k in p:
            if k == "audiopath":
                assert p[k] == j[k]
                continue
            np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(j[k]),
                                          err_msg=k)
        assert p["mels"].shape[1] == p_shape[1]
        assert p["text"].shape[1] == p_shape[0]


def test_rank_slices_and_allgather(run, monkeypatch):
    """Each rank's rows of a global batch of 8 are JAX's for that process of
    2, and 7 rows raise as in JAX."""
    import jax
    from cookietts_tpu.parallel.launch import global_batch_slice as jax_slice
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    for r, res in enumerate(run["ranks"]):
        monkeypatch.setattr(jax, "process_index", lambda: r)
        assert res["slice"] == jax_slice(8) == slice(4 * r, 4 * r + 4)
        with pytest.raises(ValueError) as e:
            jax_slice(7)
        assert res["slice_error"].split(" — ")[0] == str(e.value).split(
            " — ")[0]
        assert res["gathered"] == [{"rank": 0}, {"rank": 1}]


def test_tacotron2_steps_match_one_process_and_jax(run):
    """Three steps at 2 ranks with unequal valid frames: the global loss
    terms, parameters, Adam moments and BatchNorm statistics of one process
    on the global batch; the first step's terms JAX's."""
    want_losses, want_state = run["one"]["taco"]
    twin_losses, twin_state = run["one"]["taco_swap"]
    for res in run["ranks"]:
        losses, state = res["taco"]
        for got, want, twin in zip(losses, want_losses, twin_losses):
            _hold_losses(*({k: d[k] for k in TERMS} for d in (got, want,
                                                              twin)))
        _hold_states(state, want_state, twin_state, 3 * CTRL["lr"])
    for k, v in run["one"]["jax"].items():
        np.testing.assert_allclose(run["ranks"][0]["taco"][0][0][k], v,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert any(k.endswith("running_var") for k in want_state)
    # the replicas hold the same bits
    s0, s1 = run["ranks"][0]["taco"][1], run["ranks"][1]["taco"][1]
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_local_means_miss_the_tolerance(run):
    """The negative control: each rank's own means averaged (and local
    BatchNorm statistics) is another step on these batches, by the same
    measure."""
    want_losses, want_state = run["one"]["taco"]
    twin_losses, twin_state = run["one"]["taco_swap"]
    losses, state = run["ranks"][0]["taco_local"]
    for k in ("loss", "spec_MFSE", "diag_att"):
        assert _violations(losses[0][k], want_losses[0][k],
                           twin_losses[0][k], 1e-7, LOSS_RTOL), k
    missed = _state_misses(state, want_state, twin_state, 3 * CTRL["lr"])
    assert any(k.endswith(("running_mean", "running_var")) for k in missed)
    assert any(k.endswith("weight") for k in missed), missed


@pytest.mark.parametrize("name", ["hifigan", "postnet"])
def test_gan_iteration_matches_one_process(run, name):
    """One D and one G step at 2 ranks: one process's metrics, parameters,
    moments and (the postnet's) BatchNorm statistics."""
    want_metrics, want_state = run["one"][name]
    # HiFi-GAN has no BatchNorm: held without the reordering's allowance
    twin_metrics, twin_state = run["one"].get(name + "_swap",
                                              (want_metrics, want_state))
    for res in run["ranks"]:
        metrics, state = res[name]
        assert set(metrics) == set(want_metrics)
        _hold_losses(metrics, want_metrics, twin_metrics)
        _hold_states(state, want_state, twin_state,
                     1e-3 if name == "postnet" else 1e-4)


def test_train_command_one_writer_and_one_process_losses(run):
    out = run["out"]
    two, one = os.path.join(out, "taco"), os.path.join(out, "taco1")
    r0, r1 = (r["taco_cli"] for r in run["ranks"])
    assert r0["steps"] == r1["steps"] == 3
    assert r0["logger_writes"] and not r1["logger_writes"]
    assert r1["saves"] == [] and sorted(map(os.path.basename, r0["saves"])) == [
        "best_inf_attsc", "best_val_model", "checkpoint_2", "checkpoint_3"]
    files = lambda d: sorted(f for f in os.listdir(d)  # noqa: E731
                             if not f.startswith("events.out.tfevents"))
    assert files(two) == files(one)
    assert sum(f.startswith("events.out.tfevents") for f in os.listdir(two)) == 1
    ev2, ev1 = _events(two), _events(one)
    assert [(e["prefix"], e["step"]) for e in ev2] == [
        (e["prefix"], e["step"]) for e in ev1]
    for a, b in zip(ev2, ev1):
        for k in ("loss", "val_loss", "val_inf_weighted_score"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                           atol=1e-6, err_msg=f"{b['step']} {k}")


def test_resumed_runs_at_two_ranks_match_uninterrupted(run):
    """GAN-TTS's train command (z, window starts and dropout drawn every
    iteration) to 4 against 2 then --resume to 4, both at 2 ranks: the same
    bits, and one process's per-iteration losses; a Tacotron2 Trainer with
    dropouts on resumed at 2 ranks, exactly."""
    out = run["out"]
    assert all(r["vocoder_cli"]["steps"] == 4 for r in run["ranks"])
    assert run["ranks"][1]["vocoder_cli"]["saves"] == []
    straight = torch.load(os.path.join(out, "gantts", "checkpoint_4"))
    resumed = torch.load(os.path.join(out, "gantts_r", "checkpoint_4"))
    for part in ("state_dict", "d_state_dict"):
        for k, v in straight[part].items():
            assert torch.equal(resumed[part][k], v), k
    train = lambda d: {e["step"]: e["loss"]  # noqa: E731
                       for e in _events(os.path.join(out, d))
                       if e["prefix"] == "train"}
    s, r = train("gantts"), train("gantts_r")
    assert sorted(s) == sorted(r) == [0, 1, 2, 3] and s == r
    one = train("gantts1")
    assert sorted(one) == [0, 1, 2, 3]
    np.testing.assert_allclose([s[k] for k in one], list(one.values()),
                               rtol=LOSS_RTOL)
    assert [r["trainer_resume_diff"] for r in run["ranks"]] == [0.0, 0.0]


@pytest.mark.parametrize("what,message", [
    ("untts", "trains in one process only"),
    ("waveglow", "trains in one process only"),
    ("batch", "batch_size=3 must divide evenly over the 2 ranks")])
def test_refusals_at_two_ranks(run, what, message):
    for res in run["ranks"]:
        assert message in (res["refusals"][what] or ""), res["refusals"]


# -- without a group --------------------------------------------------------------

def test_no_group_is_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize("cpu") is False
    assert global_batch_slice(5) == slice(0, 5)
    assert allgather_object({"a": 1}) == [{"a": 1}]
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(draw_rows(torch.rand, (3, 2), generator=g1),
                       torch.rand((3, 2), generator=g2))
    x = torch.randn(3)
    assert SINGLE.share(x) is x and SINGLE.report({"x": x})["x"] is x
    assert SINGLE.shard_batch({"a": [1, 2]}) == {"a": [1, 2]}


def test_nccl_refuses_the_cpu(monkeypatch):
    """Under torchrun's environment, NCCL on the CPU refuses before any
    group is made (nothing switches backend)."""
    import torch.distributed as dist
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="needs the card"):
        initialize("cpu", "nccl")
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv,message", [
    (["--sp", "2"], "only wired for --model waveglow/waveflow"),
    (["--tp", "2", "--model", "hifigan"],
     "--tp 2 .*--model tacotron2 and --model waveglow"),
    (["--tp", "2"], "a world of 1 ranks is not a multiple of --tp 2")])
def test_tp_and_sp_refuse_naming_the_next_slice(tmp_path, argv, message):
    """--sp refuses a model other than waveglow, with JAX's message; --tp
    refuses a model JAX does not shard, naming the two it takes, and a
    world it does not divide."""
    with pytest.raises(SystemExit, match=message):
        cli(["train", "--device", "cpu", "--filelist", "x", *argv,
             "--run_dir", str(tmp_path)])


if __name__ == "__main__":
    worker(sys.argv[1])
