"""Tensor parallelism (cookietts_tpu_torch/parallel/tp.py) on the CPU: two
gloo ranks in one tp group against one process and against JAX.

One 2-rank run serves the module: the file starts itself twice with
torchrun's environment, and each rank saves what it computed into the run's
directory, while this process computes the one-process runs and JAX's
losses. Checked:

- the rules: the decoder cells, the encoder convs and the WN layers shard,
  a weight whose blocks do not divide stays replicated, and shards join
  back into the full tensor;
- three Tacotron2 train steps at tp 2 (tests/test_tp.py's small
  configuration, dropouts off, SylpsNet's eps JAX's) against one process:
  losses and gradient norms within rel 1e-5, the gathered parameters and
  Adam moments within test_tp.py's atol / rtol 1e-4 (an element whose
  gradient is rounding noise may take Adam's normalised step either way:
  2 lr a step); the first step's loss terms JAX's; each rank's cells call
  lstm_gates with W [In+H, 4H/N] and c [B, H/N];
- the same for WaveGlow and WaveFlow (test_tp.py's WaveGlow
  configuration), the first loss JAX's;
- without the conjugate all-reduce the replicated weights' gradients differ
  between the ranks;
- a Trainer at tp 2 writes the one-process checkpoint (every key, full
  shapes), and resuming it at N = 1 and at N = 2 gives the uninterrupted
  run's next losses;
- the train command with ``--tp 2`` for tacotron2 (zoneout and dropouts
  on, validate_at_start, async_save) and waveglow against one process:
  per-iteration losses, the iteration-0 validation, one writer.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.device import batch_to_device
from cookietts_tpu_torch.losses import DEFAULT_LOSS_SCALARS
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
from cookietts_tpu_torch.ops import hopper_kernels as hk
from cookietts_tpu_torch.parallel import (TACOTRON2_TP_RULES,
                                          WAVEGLOW_TP_RULES, TensorParallel,
                                          describe, initialize, make_mesh,
                                          shard_model)
from cookietts_tpu_torch.parallel.tp import join_shards, plan, shard_tensor
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import TrainState
from cookietts_tpu_torch.runtime.trainer import (Trainer, TrainerConfig,
                                                 make_tacotron2_train_step,
                                                 make_waveglow_train_step)
from test_torch_threads import _one_thread  # noqa: F401
from torch_ranks import RANK_TIMEOUT, Ranks

WORLD = 2
ATOL = RTOL = 1e-4            # tests/test_tp.py's
LOSS_RTOL = 1e-5              # tests/test_torch_parallel.py's

# tests/test_tp.py:85-94's Tacotron2, dropouts and the postnet (its dropout
# is fixed at 0.5) off; SylpsNet's eps given
TACO = dict(
    n_symbols=40, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, n_mel_channels=10, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_dim=12, torchmoji_crushed_dim=4, memory_bottleneck_dim=16,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=12,
    second_decoder_rnn_dim=0, attention_dim=8, windowed_attention_range=4,
    postnet_embedding_dim=16, postnet_n_convolutions=2,
    postnet_residual_connections=0)
NO_DROP = dict(p_prenet_dropout=0.0, encoder_conv_dropout=0.0,
               p_attrnn_dropout=0.0, p_decrnn_dropout=0.0, use_postnet=False)
B, T_TXT, T_DEC = 4, 12, 16
CTRL = {"lr": 1e-3, "grad_clip": 1.0, "p_teacher_forcing": 1.0,
        "teacher_force_till": 20, "drop_frame_rate": 0.0,
        "guided_att_sigma": 0.5, **DEFAULT_LOSS_SCALARS}
TERMS = ("loss", "spec_MSE", "postnet_MSE", "gate_loss", "sylps_kld",
         "sylps_MSE", "diag_att")
# tests/test_tp.py:32-36's WaveGlow, and a WaveFlow of its widths
FLOWS = {
    "waveglow": dict(n_mel_channels=16, n_flows=2, n_group=4,
                     n_early_every=4, n_early_size=2, n_layers=2,
                     n_channels=32, hop_length=32, upsample_strides=(4, 2),
                     upsample_channels=24, memory_efficient=False),
    "waveflow": dict(n_mel_channels=16, n_flows=2, n_group=8,
                     channel_mixing="permuteheight", n_layers=2,
                     n_channels=32, hop_length=32, upsample_strides=(4,),
                     upsample_channels=24, memory_efficient=True),
}
FLOW_B, FLOW_T_MEL = 4, 6
FLOW_CTRL = {"lr": 1e-3, "grad_clip": 100.0}
JAX_KEY = 5

# the train commands: a tiny Tacotron2 with zoneout and the dropouts on
CLI_TACO = ("sampling_rate=22050,filter_length=1024,hop_length=256,"
            "win_length=1024,mel_fmax=8000.0,trim_enable=False,"
            "mel_buckets=[64],max_segment_frames=64,batch_size=4,log_every=1,"
            "validation_interval=2,checkpoint_interval=2,"
            "curation_enable=False,validate_at_start=True,async_save=True,"
            "symbols_embedding_dim=16,n_speakers=4,speaker_embedding_dim=8,"
            "encoder_speaker_embed_dim=4,encoder_conv_hidden_dim=16,"
            "encoder_lstm_dim=16,encoder_n_convolutions=2,torchmoji_dim=8,"
            "torchmoji_crushed_dim=4,memory_bottleneck_dim=16,prenet_dim=8,"
            "attention_rnn_dim=16,decoder_rnn_dim=12,"
            "second_decoder_rnn_dim=12,attention_dim=8,"
            "windowed_attention_range=2,postnet_embedding_dim=16,"
            "postnet_n_convolutions=2,attrnn_zoneout=0.1,decrnn_zoneout=0.1")
CLI_FLOW = ("batch_size=2,segment_length=2560,sampling_rate=16000,"
            "filter_length=512,hop_length=128,win_length=512,"
            "n_mel_channels=16,mel_fmax=8000.0,load_from_disk_dtw=False,"
            "log_every=1,validation_interval=2,checkpoint_interval=3,"
            "validate_at_start=True,n_layers=2,n_channels=8,"
            "upsample_channels=8,n_flows=2,n_group=4,n_early_every=0,"
            "upsample_strides=[4,8]")


# -- the models and their steps ------------------------------------------------

def taco_model(sd, **over):
    model = Tacotron2(Tacotron2Config(**TACO, **NO_DROP, **over),
                      device="cpu")
    model.load_state_dict(sd)
    return model


def taco_batch():
    rng = np.random.default_rng(0)
    ml = np.array([16, 14, 9, 5])
    valid = np.arange(T_DEC)[None, :, None] < ml[:, None, None]
    return dict(
        text=rng.integers(1, TACO["n_symbols"], (B, T_TXT)),
        text_lengths=np.array([12, 11, 7, 4]),
        mels=(rng.normal(0, 1, (B, T_DEC, 10)) * valid).astype(np.float32),
        mel_lengths=ml, speaker_id=np.array([1, 3, 0, 2]),
        sylps=np.array([3.0, 4.5, 5.0, 3.5], np.float32),
        torchmoji=rng.normal(0, 1, (B, 12)).astype(np.float32),
        gate_target=(np.arange(T_DEC)[None] >= ml[:, None] - 1).astype(
            np.float32),
        pres_prev_state=np.zeros(B, np.float32),
        global_mean=rng.normal(0, 1, 10).astype(np.float32))


def _full(state):
    """The full (gathered under tp) state dict and Adam moments, by name."""
    tree = state.to_host_tree()
    out = dict(tree["state_dict"])
    for k in tree["opt_state"]["mu"]:
        out[f"mu.{k}"] = tree["opt_state"]["mu"][k]
        out[f"nu.{k}"] = tree["opt_state"]["nu"][k]
    return out


class GateShapes:
    """hk.lstm_gates wrapped to record each call's (W, c) shapes."""

    def __init__(self):
        self.shapes, self._real = set(), hk.lstm_gates

    def __enter__(self):
        def spy(xh, w, b, c):
            self.shapes.add((tuple(w.shape), tuple(c.shape)))
            return self._real(xh, w, b, c)
        hk.lstm_gates = spy
        return self

    def __exit__(self, *exc):
        hk.lstm_gates = self._real


def taco_steps(inputs, tp, steps=3):
    """``steps`` train steps from the given weights on the batch -> (loss
    dicts with the gradient norm, full state, the lstm_gates shapes, the
    first step's local gradients of the replicated weights)."""
    model = taco_model(inputs["taco"])
    if tp is not None:
        shard_model(model, TACOTRON2_TP_RULES, tp)
    state = TrainState.create(model, adam())
    step = make_tacotron2_train_step(model)
    dev = batch_to_device(dict(inputs["batch"], sylps_noise=inputs["eps"]),
                          "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    with GateShapes() as spy:
        for _ in range(steps):
            _, ld, _, _ = step(state, dev, gen, CTRL)
            losses.append({k: float(v) for k, v in ld.items()})
    return losses, _full(state), spy.shapes


def replicated_grads(inputs, tp):
    """The gradients of the loss for the replicated parameters at the
    given weights (one backward, no update)."""
    from cookietts_tpu_torch.losses import tacotron2_loss
    from cookietts_tpu_torch.models.tacotron2 import batch_inputs
    from cookietts_tpu_torch.runtime.trainer import _targets
    model = taco_model(inputs["taco"])
    layout = shard_model(model, TACOTRON2_TP_RULES, tp)
    model.train()
    batch = batch_to_device(dict(inputs["batch"], sylps_noise=inputs["eps"]),
                            "cpu")
    out, _ = model(**batch_inputs(batch), generator=torch.Generator(),
                   p_teacher_forcing=1.0, teacher_force_till=20,
                   drop_frame_rate=0.0, global_mean=batch["global_mean"])
    gt = dict(_targets(batch), pres_prev_state=batch["pres_prev_state"])
    total, _, _ = tacotron2_loss(out, gt)
    names = [k for k, p in model.named_parameters()
             if p.requires_grad and k not in layout.names]
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, [params[k] for k in names],
                                allow_unused=True)
    return {k: g for k, g in zip(names, grads) if g is not None}


def flow_batch(name):
    cfg = WaveGlowConfig(**FLOWS[name])
    rng = np.random.default_rng(1)
    return {"audio": (0.3 * rng.standard_normal(
                (FLOW_B, FLOW_T_MEL * cfg.hop_length))).astype(np.float32),
            "mels": rng.normal(-5, 1, (FLOW_B, FLOW_T_MEL, 16)).astype(
                np.float32)}


def flow_steps(name, sd, tp, steps=3):
    model = WaveGlow(WaveGlowConfig(**FLOWS[name]), device="cpu")
    model.load_state_dict(sd)
    if tp is not None:
        shard_model(model, WAVEGLOW_TP_RULES, tp)
    model.train()
    state = TrainState.create(model, adam())
    step = make_waveglow_train_step(model)
    batch = batch_to_device(flow_batch(name), "cpu")
    losses = []
    for _ in range(steps):
        _, m = step(state, batch, None, FLOW_CTRL)
        losses.append({k: float(v) for k, v in m.items()})
    return losses, _full(state)


def trainer_batches(n=4):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        b = taco_batch()
        b["mels"] = (b["mels"] + rng.normal(0, 0.1, b["mels"].shape)).astype(
            np.float32)
        b["audiopath"] = [f"u{i}_{j}.wav" for j in range(B)]
        out.append(b)
    return out


def resumed_trainer(out, run, sd, tp, batches, seed=7, dp=None):
    """A Trainer (dropouts on) over ``batches``: 2 iterations, a periodic
    save, 2 more; or, when ``run`` holds a checkpoint, resumed from it for
    the last 2. -> the train losses by step. Under a group ``dp`` (its
    rank 0 writes)."""
    model = Tacotron2(Tacotron2Config(**TACO, use_postnet=False),
                      device="cpu")
    model.load_state_dict(sd)
    if tp is not None:
        shard_model(model, TACOTRON2_TP_RULES, tp)
    t = Trainer(TrainerConfig(run_dir=os.path.join(out, run), seed=seed,
                              log_every=1),
                TrainState.create(model, adam()),
                make_tacotron2_train_step(model, dp=dp), device="cpu", dp=dp)
    t.live.values.update(validation_interval=0, checkpoint_interval=0)
    losses = {}
    start = t.resume() if t.ckpt.latest() else 0
    for i in range(start, len(batches)):
        losses[i] = t.step(batches[i])["loss"]
        if i == 1:
            t.save(periodic=True)
    return losses


def taco_cli(corpus, run, extra=()):
    return ["train", "--device", "cpu", "--filelist", corpus, "--run_dir",
            run, "--seed", "3", "--iters", "3", "--hparams", CLI_TACO,
            *extra]


def flow_cli(map_file, run, extra=()):
    return ["train", "--model", "waveglow", "--device", "cpu", "--filelist",
            map_file, "--run_dir", run, "--seed", "3", "--iters", "3",
            "--hparams", CLI_FLOW, *extra]


class NoConjugate(TensorParallel):
    """The negative control: a column-parallel product's replicated input
    without its backward all-reduce (each rank keeps its own part of the
    input's gradient)."""

    def copy_in(self, x):
        return x


def worker(out):
    """One rank of the module's run (started with torchrun's environment)."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    assert initialize("cpu", timeout=RANK_TIMEOUT)
    dp, tp, _ = make_mesh(WORLD)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    res = {"rank": dist.get_rank(), "dp_size": dp.size, "tp_rank": tp.rank}
    res["taco"] = taco_steps(inputs, tp)
    res["flows"] = {n: flow_steps(n, inputs[n], tp) for n in FLOWS}
    res["grads"] = replicated_grads(inputs, tp)
    res["grads_no_conjugate"] = replicated_grads(
        inputs, NoConjugate(tp.group, tp.ranks))
    batches = trainer_batches()
    res["straight"] = resumed_trainer(out, "straight2", inputs["taco"], tp,
                                      batches, dp=dp)
    if dist.get_rank() == 0:
        os.makedirs(os.path.join(out, "resumed2"))
        for f in ("checkpoint_2", "checkpoint_2.json"):
            shutil.copy(os.path.join(out, "straight2", f),
                        os.path.join(out, "resumed2", f))
    dist.barrier()
    res["resumed"] = resumed_trainer(out, "resumed2", inputs["taco"], tp,
                                     batches, seed=8, dp=dp)
    with GateShapes() as spy:
        trainer = cli(taco_cli(inputs["corpus"], os.path.join(out, "cli_taco"),
                               ["--tp", "2"]))
    res["cli_taco"] = {"steps": int(trainer.state.step),
                       "gate_shapes": spy.shapes,
                       "writes": trainer.logger._jsonl is not None}
    trainer = cli(flow_cli(inputs["map"], os.path.join(out, "cli_flow"),
                           ["--tp", "2"]))
    res["cli_flow"] = {"steps": int(trainer.state.step)}
    torch.save(res, os.path.join(out, f"rank{dist.get_rank()}.pt"))
    dist.barrier()


# -- the module's run ------------------------------------------------------------

def taco_weights():
    torch.manual_seed(0)
    model = Tacotron2(Tacotron2Config(**TACO, **NO_DROP), device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for k, v in model.named_buffers():
            if "running" in k:
                v.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    return model.state_dict()


def jax_sylps_eps():
    import jax
    _, k_mem, _, _ = jax.random.split(jax.random.PRNGKey(JAX_KEY), 4)
    return np.asarray(jax.random.normal(jax.random.split(k_mem)[1], (B,)))


def jax_taco_terms(state_dict, batch):
    """JAX's Tacotron2 in training form on the batch from the same weights
    (JAX's converter of the reference layout): its loss terms."""
    import jax
    import jax.numpy as jnp
    from cookietts_tpu.convert import convert_tacotron2_state_dict
    from cookietts_tpu.losses import tacotron2_loss as jax_loss
    from cookietts_tpu.models.tacotron2 import (Tacotron2 as JTacotron2,
                                               Tacotron2Config as JConfig)
    params, stats = convert_tacotron2_state_dict(
        {k: v.numpy() for k, v in state_dict.items()})
    jm = JTacotron2(JConfig(**TACO, **NO_DROP))
    v = {"params": params, "batch_stats": stats}
    jb = {k: jnp.asarray(val) for k, val in batch.items()}
    carry = jm.apply(v, B, T_TXT, TACO["memory_bottleneck_dim"], jnp.float32,
                     method=lambda m, *a: m.decoder.init_carry(*a))
    (out, _), _ = jm.apply(
        v, text=jb["text"], text_lengths=jb["text_lengths"], mels=jb["mels"],
        mel_lengths=jb["mel_lengths"], speaker_id=jb["speaker_id"],
        sylps=jb["sylps"], torchmoji_hidden=jb["torchmoji"],
        key=jax.random.PRNGKey(JAX_KEY), p_teacher_forcing=1.0,
        teacher_force_till=20, drop_frame_rate=0.0,
        global_mean=jb["global_mean"], deterministic=False, init_carry=carry,
        pres_prev_state=jb["pres_prev_state"],
        rngs={"dropout": jax.random.PRNGKey(9)}, mutable=["batch_stats"])
    gt = {k: jb[k] for k in ("mels", "mel_lengths", "text_lengths", "sylps",
                             "gate_target", "pres_prev_state")}
    ld = jax_loss(out, gt)[1]
    return {k: float(ld[k]) for k in TERMS if k in ld}


def jax_flow(name):
    """(the port's state dict, JAX's loss) from JAX's init plus noise."""
    import jax
    import jax.numpy as jnp
    from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
    from cookietts_tpu.models.waveglow import WaveGlowConfig as JConfig
    from cookietts_tpu.models.waveglow import waveglow_loss as j_loss
    from cookietts_tpu_torch.convert.from_jax import waveglow_from_jax
    jcfg = JConfig(**FLOWS[name])
    jm = JWaveGlow(jcfg)
    b = flow_batch(name)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(b["audio"]),
                jnp.asarray(b["mels"]))["params"])
    out = jm.apply({"params": params}, jnp.asarray(b["audio"]),
                   jnp.asarray(b["mels"]))
    port = WaveGlow(WaveGlowConfig(**FLOWS[name]), device="cpu")
    port.load_state_dict(waveglow_from_jax(params, port.cfg))
    return port.state_dict(), float(j_loss(out)[0])


def flow_map(root):
    from cookietts_tpu_torch.data import audio_io
    os.makedirs(root)
    rng = np.random.default_rng(1)
    lines = []
    for i in range(4):
        t = np.arange(8000) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t)
                 + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        audio_io.save_wav(os.path.join(root, f"v{i}.wav"), audio, 16000)
        lines.append(f"{os.path.join(root, f'v{i}.wav')}||{i}")
    with open(os.path.join(root, "map.txt"), "w") as f:
        f.write("\n".join(lines))
    return os.path.join(root, "map.txt")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 2-rank run and, meanwhile, the one-process runs and JAX."""
    from cookietts_tpu_torch.data.evidence_corpus import make_corpus
    out = str(tmp_path_factory.mktemp("tp"))
    flows = {n: jax_flow(n) for n in FLOWS}
    inputs = {"taco": taco_weights(), "batch": taco_batch(),
              "eps": jax_sylps_eps(),
              "corpus": make_corpus(os.path.join(out, "corpus"), seed=0,
                                    n_train=8, n_val=4)[0],
              "map": flow_map(os.path.join(out, "wavs")),
              **{n: sd for n, (sd, _) in flows.items()}}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    ranks = Ranks(__file__, out, WORLD)
    try:
        one = {"jax_taco": jax_taco_terms(inputs["taco"], inputs["batch"]),
               "jax_flows": {n: loss for n, (_, loss) in flows.items()},
               "taco": taco_steps(inputs, None),
               "flows": {n: flow_steps(n, inputs[n], None) for n in FLOWS},
               "straight": resumed_trainer(out, "straight1", inputs["taco"],
                                           None, trainer_batches())}
        cli(taco_cli(inputs["corpus"], os.path.join(out, "cli_taco1")))
        cli(flow_cli(inputs["map"], os.path.join(out, "cli_flow1")))
        ranks.wait()
    finally:
        ranks.close()
    # the tp run's checkpoint resumed in one process
    os.makedirs(os.path.join(out, "resumed1"))
    for f in ("checkpoint_2", "checkpoint_2.json"):
        shutil.copy(os.path.join(out, "straight2", f),
                    os.path.join(out, "resumed1", f))
    one["resumed"] = resumed_trainer(out, "resumed1", inputs["taco"], None,
                                     trainer_batches(), seed=8)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return dict(out=out, one=one, ranks=ranks, inputs=inputs)


# -- the checks ------------------------------------------------------------------

def _hold_state(got, want, lr_steps):
    """Every entry within atol / rtol 1e-4; a parameter element whose
    gradient is rounding noise (|mu| <= 1e-6 in the one-process run) within
    Adam's normalised step either way, 2 lr a step."""
    assert set(got) == set(want)
    bad = []
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
            continue
        assert got[k].shape == w.shape, k
        allowed = ATOL + RTOL * w.abs()
        mu = want.get(f"mu.{k}")
        if mu is not None:
            allowed = torch.where(mu.abs() <= 1e-6,
                                  torch.full_like(allowed, 2 * lr_steps),
                                  allowed)
        if ((got[k] - w).abs() > allowed).any():
            bad.append((k, float((got[k] - w).abs().max())))
    assert not bad, bad


def _hold_losses(got, want, keys):
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)


def test_the_rules_shard_and_replicate():
    """The cells shard by unit and the encoder conv by channel at N = 2;
    at N = 3 the 16-unit attention RNN does not divide and stays
    replicated while the 12-unit decoder RNN shards; join undoes shard."""
    model = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    sd = model.state_dict()
    two = plan(model, TACOTRON2_TP_RULES, 2)
    assert {"decoder.attention_rnn.weight_ih", "decoder.decoder_rnn.weight_hh",
            "encoder.convolutions.0.0.conv.weight",
            "encoder.convolutions.0.1.running_var"} <= set(two)
    assert two["decoder.attention_rnn.weight_ih"].block == 16
    three = plan(model, TACOTRON2_TP_RULES, 3)
    assert "decoder.attention_rnn.weight_ih" not in three
    assert "decoder.decoder_rnn.weight_ih" in three
    assert "decoder.attention_rnn.weight_ih" not in describe(
        three, {k: tuple(v.shape) for k, v in sd.items()}, 3)
    w = sd["decoder.decoder_rnn.weight_ih"]
    parts = [shard_tensor(w, three["decoder.decoder_rnn.weight_ih"], r, 3)
             for r in range(3)]
    # rank 1 holds units 4-7 of each of the four gate blocks
    assert torch.equal(parts[1][:4], w[4:8])
    assert torch.equal(parts[1][4:8], w[16:20])
    assert torch.equal(join_shards(parts, three["decoder.decoder_rnn."
                                                "weight_ih"]), w)
    glow = WaveGlow(WaveGlowConfig(**FLOWS["waveglow"]), device="cpu")
    wplan = plan(glow, WAVEGLOW_TP_RULES, 2)
    assert wplan["WN.0.cond_layer.weight"].block == 32
    assert wplan["WN.0.res_skip_layers.1.weight"].dim == 1
    assert not any(k.startswith(("WN.0.end", "convinv", "upsample"))
                   for k in wplan)
    # HiFi-GAN's rules, carried as data: the one-channel output conv stays
    # replicated
    from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from cookietts_tpu_torch.parallel import HIFIGAN_TP_RULES
    gen = Generator(HiFiGANConfig(
        n_mel_channels=16, resblock_kernel_sizes=(3,),
        resblock_dilations=((1, 3),), upsample_rates=(4, 4),
        upsample_kernel_sizes=(8, 8), upsample_initial_channel=16),
        device="cpu")
    hplan = plan(gen, HIFIGAN_TP_RULES, 2)
    assert {"conv_pre.weight", "ups.1.weight",
            "resblocks.0.convs1.0.weight"} <= set(hplan)
    assert hplan["ups.0.weight"].dim == 1 and "conv_post.weight" not in hplan


def test_tacotron2_steps_match_one_process_and_jax(run):
    want_losses, want_state, want_shapes = run["one"]["taco"]
    for res in run["ranks"]:
        assert res["dp_size"] == 1
        losses, state, shapes = res["taco"]
        _hold_losses(losses, want_losses, TERMS + ("grad_norm",))
        _hold_state(state, want_state, 3 * CTRL["lr"])
        # each cell at 4H/N columns: attention RNN 16 -> 8, decoder 12 -> 6
        assert {s[0][1] for s in shapes} == {32, 24}
        assert {s[1][1] for s in shapes} == {8, 6}
    assert {s[0][1] for s in want_shapes} == {64, 48}
    for k, v in run["one"]["jax_taco"].items():
        np.testing.assert_allclose(run["ranks"][0]["taco"][0][0][k], v,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    # the two ranks gathered the same bits
    s0, s1 = run["ranks"][0]["taco"][1], run["ranks"][1]["taco"][1]
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_flow_steps_match_one_process_and_jax(run, name):
    want_losses, want_state = run["one"]["flows"][name]
    for res in run["ranks"]:
        losses, state = res["flows"][name]
        _hold_losses(losses, want_losses, ("loss", "grad_norm"))
        _hold_state(state, want_state, 3 * FLOW_CTRL["lr"])
    np.testing.assert_allclose(want_losses[0]["loss"],
                               run["one"]["jax_flows"][name], rtol=LOSS_RTOL)


def test_the_conjugate_all_reduce_is_needed(run):
    """With it, both ranks hold the same gradient for every replicated
    weight; without it (each rank's part of the gradient of the cells'
    replicated inputs only) the ranks' gradients differ."""
    r0, r1 = (r["grads"] for r in run["ranks"])
    assert all(torch.equal(r0[k], r1[k]) for k in r0)
    n0, n1 = (r["grads_no_conjugate"] for r in run["ranks"])
    differ = [k for k in n0 if not torch.allclose(n0[k], n1[k], rtol=1e-3,
                                                  atol=1e-6)]
    assert "embedding.weight" in differ and "decoder.prenet.layers.0." \
        "linear_layer.weight" in differ, differ


def test_checkpoint_is_one_process_file_and_resumes_at_any_n(run):
    out = run["out"]
    def flat(path):
        tree = torch.load(path)
        out = dict(tree["state_dict"])
        for k in tree["opt_state"]["mu"]:
            out[f"mu.{k}"] = tree["opt_state"]["mu"][k]
            out[f"nu.{k}"] = tree["opt_state"]["nu"][k]
        return out

    tp_ck = torch.load(os.path.join(out, "straight2", "checkpoint_2"))
    # every key at its full shape, the values one process's (2 steps at
    # the live config's learning rate, at most 1e-3)
    _hold_state(flat(os.path.join(out, "straight2", "checkpoint_2")),
                flat(os.path.join(out, "straight1", "checkpoint_2")), 2e-3)
    full = Tacotron2(Tacotron2Config(**TACO, use_postnet=False),
                     device="cpu")
    full.load_state_dict(tp_ck["state_dict"])       # loads in one process
    straight = run["ranks"][0]["straight"]
    np.testing.assert_allclose([straight[i] for i in range(4)],
                               [run["one"]["straight"][i] for i in range(4)],
                               rtol=LOSS_RTOL)
    for resumed in (run["one"]["resumed"], run["ranks"][0]["resumed"],
                    run["ranks"][1]["resumed"]):
        assert sorted(resumed) == [2, 3]
        np.testing.assert_allclose([resumed[2], resumed[3]],
                                   [straight[2], straight[3]],
                                   rtol=LOSS_RTOL)


def _events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", ["cli_taco", "cli_flow"])
def test_train_command_at_tp_2_matches_one_process(run, name):
    out = run["out"]
    two, one = os.path.join(out, name), os.path.join(out, name + "1")
    assert [r[name]["steps"] for r in run["ranks"]] == [3, 3]
    ev2, ev1 = _events(two), _events(one)
    assert [(e["prefix"], e["step"]) for e in ev2] == [
        (e["prefix"], e["step"]) for e in ev1]
    assert ("validation", 0) in [(e["prefix"], e["step"]) for e in ev1]
    for a, b in zip(ev2, ev1):
        for k in ("loss", "grad_norm", "val_loss"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{b['step']} {k}")
    files = lambda d: sorted(f for f in os.listdir(d)  # noqa: E731
                             if not f.startswith("events.out.tfevents"))
    assert files(two) == files(one)
    final = sorted(f for f in files(one) if f.startswith("checkpoint_")
                   and not f.endswith(".json"))[-1]
    a = torch.load(os.path.join(two, final))["state_dict"]
    b = torch.load(os.path.join(one, final))["state_dict"]
    assert {k: v.shape for k, v in a.items()} == {k: v.shape
                                                  for k, v in b.items()}
    if name == "cli_taco":
        shapes = run["ranks"][0][name]["gate_shapes"]
        # attention RNN 16 and both decoder RNNs 12 units at 4H/N columns
        assert {s[0][1] for s in shapes} == {32, 24}
        assert [r[name]["writes"] for r in run["ranks"]] == [True, False]


if __name__ == "__main__":
    worker(sys.argv[1])
