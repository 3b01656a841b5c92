"""Sequence parallelism (cookietts_tpu_torch/parallel/sp.py) on the CPU: four
gloo ranks, split into sp groups of 2 and 4, against one process and
against JAX.

One 4-rank run serves the module: the file starts itself four times with
torchrun's environment and each rank saves what it computed into the run's
directory, while this process computes the one-process runs and JAX's.
Checked:

- ``halo_pad`` and ``widen``, forward and gradient, against the unsharded
  pad and conv, with halos wider than a rank's run and runs of unequal
  length;
- a WaveGlow and a WaveFlow train step (tests/test_tp.py:172-176's
  configuration, B = 4, t_mel 16, the mel a frame longer than the audio's
  hops, as a training segment's is) at dp 2 x sp 2 and at sp 4, with
  ``memory_efficient`` off and on: the loss within rel 1e-5 of one
  process's and of JAX's, the parameters after one Adam step within
  test_tp.py's atol 1e-4; the "single" upsampler at sp 2; one tp 2 x sp 2
  WaveGlow step;
- without the halos (zero padding at every run's ends) the loss and the
  gradients differ;
- ``WaveGlow.infer`` at sp 4 (t_mel 32, z from numpy) against one process
  and JAX's ``WaveGlow.inverse`` (atol 2e-4, rtol 1e-4), its draw the
  one-process draw; HiFi-GAN's ``Generator`` at sp 4 on test_tp.py's
  64-frame configuration, whose reach (19 frames) is wider than a 16-frame
  run, against one process and JAX (atol 2e-5, rtol 1e-4); the WaveFlow
  inverse at dp 2 x sp 2 equal to one process;
- ``train --model waveglow --sp 2`` (dp 2 x sp 2) against one process:
  per-iteration losses, the validation at the start, one writer, and its
  checkpoint resumed in one process gives the uninterrupted run's next
  loss;
- the refusals: ``--sp 2 --model tacotron2``; a world that tp sp does not
  divide; a segment that sp hop does not divide.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                                 upsample_reach, waveglow_loss,
                                                 wn_reach)
from cookietts_tpu_torch.parallel import (WAVEGLOW_TP_RULES,
                                          SequenceParallel, initialize,
                                          make_mesh, shard_model)
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import TrainState
from cookietts_tpu_torch.runtime.trainer import make_waveglow_train_step
from test_torch_threads import _one_thread  # noqa: F401
from torch_ranks import RANK_TIMEOUT, Ranks

WORLD = 4
ATOL = RTOL = 1e-4            # tests/test_tp.py's
LOSS_RTOL = 1e-5
# tests/test_tp.py:172-176's WaveGlow, a WaveFlow of its widths and the
# "single" upsampler (one transposed conv of 3 hops, stride hop)
FLOWS = {
    "waveglow": dict(n_mel_channels=16, n_flows=2, n_group=4,
                     n_early_every=4, n_early_size=2, n_layers=2,
                     n_channels=32, hop_length=32, upsample_strides=(4, 2),
                     upsample_channels=24, memory_efficient=False),
    "waveflow": dict(n_mel_channels=16, n_flows=2, n_group=8,
                     channel_mixing="permuteheight", n_layers=2,
                     n_channels=32, hop_length=32, upsample_strides=(4,),
                     upsample_channels=24, memory_efficient=False),
    "single": dict(n_mel_channels=16, n_flows=2, n_group=4, n_early_every=0,
                   n_layers=2, n_channels=32, hop_length=32,
                   upsample_mode="single", upsample_win_length=96,
                   memory_efficient=False),
}
B, T_MEL = 4, 16
CTRL = {"lr": 1e-3, "grad_clip": 100.0}
# (name, memory_efficient, mesh (tp, sp)) of each sharded train step
STEPS = [(n, m, mesh) for n in ("waveglow", "waveflow")
         for m in (False, True) for mesh in ((1, 2), (1, 4))]
STEPS += [("single", False, (1, 2)), ("waveglow", False, (2, 2))]
INFER_T_MEL, INFER_SIGMA = 32, 0.8
# tests/test_tp.py:312-322's generator and 64-frame mel
HIFIGAN = dict(n_mel_channels=8, resblock_kernel_sizes=(3, 7),
               resblock_dilations=((1, 3, 5), (1, 3, 5)),
               upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
               upsample_initial_channel=16)
HIFIGAN_T_MEL = 64
CLI_FLOW = ("batch_size=2,segment_length=2560,sampling_rate=16000,"
            "filter_length=512,hop_length=128,win_length=512,"
            "n_mel_channels=16,mel_fmax=8000.0,load_from_disk_dtw=False,"
            "log_every=1,validation_interval=2,checkpoint_interval=2,"
            "validate_at_start=True,n_layers=2,n_channels=8,"
            "upsample_channels=8,n_flows=2,n_group=4,n_early_every=0,"
            "upsample_strides=[4,8]")
# (run, flags, more hparams) of the train commands in the 4-rank run; each
# has a one-process twin, "<run>1"
CLI_RUNS = (("cli_sp", ["--sp", "2"], ""),
            ("cli_tpsp", ["--tp", "2", "--sp", "2"],
             "channel_mixing=permuteheight"))


# -- the models and their steps ------------------------------------------------

def flow_batch(name):
    cfg = WaveGlowConfig(**FLOWS[name])
    rng = np.random.default_rng(1)
    return {"audio": torch.from_numpy((0.3 * rng.standard_normal(
                (B, T_MEL * cfg.hop_length))).astype(np.float32)),
            "mels": torch.from_numpy(rng.normal(
                -5, 1, (B, T_MEL + 1, 16)).astype(np.float32))}


def flow_model(name, sd, memory_efficient=False):
    model = WaveGlow(WaveGlowConfig(**dict(
        FLOWS[name], memory_efficient=memory_efficient)), device="cpu")
    model.load_state_dict(sd)
    return model


def _full(state):
    tree = state.to_host_tree()
    out = dict(tree["state_dict"])
    for k in tree["opt_state"]["mu"]:
        out[f"mu.{k}"] = tree["opt_state"]["mu"][k]
    return out


def flow_step(name, sd, memory_efficient=False, mesh=None):
    """One Adam step on the batch -> (metrics, the full state). ``mesh`` is
    (dp, tp, sp) of make_mesh, the batch cut to the rank's rows and run."""
    model = flow_model(name, sd, memory_efficient)
    dp = tp = sp = None
    batch = flow_batch(name)
    if mesh is not None:
        dp, tp, sp = mesh
        if tp is not None:
            shard_model(model, WAVEGLOW_TP_RULES, tp)
        batch = sp.shard_batch(dp.shard_batch(batch),
                               {"audio": 1, "mels": model.cfg.hop_length})
    model.train()
    state = TrainState.create(model, adam())
    _, m = make_waveglow_train_step(model, dp=dp, sp=sp)(state, batch, None,
                                                         CTRL)
    return {k: float(v) for k, v in m.items()}, _full(state)


class NoHalo(SequenceParallel):
    """The negative control: every run padded with zeros at its ends, as if
    it were the whole utterance."""

    def widen(self, x, left, right, dim=-1):
        return x, 0, 0

    def halo_pad(self, x, left, right):
        return F.pad(x, (left, right))


def loss_and_grads(model, batch, sp=None, dp=None):
    """The loss (the global one under a group) and every gradient (summed
    over the group) at the model's weights."""
    model.train()
    out = model(batch["audio"], batch["mels"], sp=sp)
    loss, _ = waveglow_loss(out)
    params = dict(model.named_parameters())
    if dp is not None:
        loss = dp.share(loss)
    grads = torch.autograd.grad(loss, list(params.values()))
    grads = dict(zip(params, grads))
    if dp is not None:
        grads = dp.reduce_gradients(grads)
        loss = dp.report({"loss": loss})["loss"]
    return float(loss.detach()), grads


def infer_inputs():
    rng = np.random.default_rng(3)
    cfg = WaveGlowConfig(**FLOWS["waveglow"])
    mel = rng.standard_normal((1, INFER_T_MEL, 16)).astype(np.float32)
    z = (INFER_SIGMA * rng.standard_normal(
        (1, INFER_T_MEL * cfg.hop_length // cfg.n_group, cfg.n_group))
         ).astype(np.float32)
    hmel = rng.standard_normal((1, HIFIGAN_T_MEL, 8)).astype(np.float32)
    return mel, z, hmel


def cut(x, rank, n, dim=1):
    """Rank ``rank``'s run of ``n`` equal runs of a tensor's axis."""
    w = x.shape[dim] // n
    return x.narrow(dim, rank * w, w)


# -- one rank of the module's run ----------------------------------------------

def halo_cases():
    """(name, sizes, left, right, dilation) of the halo checks: halos within
    a run, wider than one and than two, and runs of unequal length."""
    return [("within", [10] * 4, 2, 2, 2), ("one run", [10] * 4, 8, 8, 8),
            ("wider", [10] * 4, 15, 16, 1), ("unequal", [9, 12, 7, 12], 13,
                                             5, 1)]


def halo_run(sp, case):
    """The rank's halo_pad + conv output and input gradient, and its widen
    (steps added, the widened run)."""
    _, sizes, left, right, d = case
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, sum(sizes), generator=g)
    w = torch.randn(5, 3, (left + right) // d + 1, generator=g)
    b = sp.along(sizes)
    xs = b.columns(x).clone().requires_grad_(True)
    y = F.conv1d(b.halo_pad(xs, left, right), w, dilation=d)
    y.backward(b.columns(torch.randn(2, 5, sum(sizes), generator=g)))
    wide, l, r = b.widen(b.columns(x), left, right)
    return y.detach(), xs.grad, (l, r, wide)


def worker(out):
    """One rank of the module's run (started with torchrun's environment)."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    assert initialize("cpu", timeout=RANK_TIMEOUT)
    rank = dist.get_rank()
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    meshes = {(1, 2): make_mesh(1, 2), (1, 4): make_mesh(1, 4),
              (2, 2): make_mesh(2, 2)}
    res = {"rank": rank, "rows": {k: (m[0].row_index, m[0].row_count,
                                      m[0].size) for k, m in meshes.items()},
           "sp_rank": {k: m[2].rank for k, m in meshes.items()}}
    sp4 = meshes[(1, 4)][2]
    res["halo"] = [halo_run(sp4, c) for c in halo_cases()]
    res["steps"] = [flow_step(n, inputs[n], me, meshes[mesh])
                    for n, me, mesh in STEPS]
    # the halos are needed
    model = flow_model("waveglow", inputs["waveglow"])
    batch = sp4.shard_batch(flow_batch("waveglow"), {"audio": 1, "mels": 32})
    res["with_halo"] = loss_and_grads(model, batch, sp4, meshes[(1, 4)][0])
    no = NoHalo(sp4.group, sp4.ranks)
    res["no_halo"] = loss_and_grads(model, batch, no, meshes[(1, 4)][0])
    # inference
    mel, z, hmel = inputs["infer"]
    glow = flow_model("waveglow", inputs["waveglow"])
    res["infer"] = glow.infer(cut(torch.from_numpy(mel), rank, 4),
                              z=cut(torch.from_numpy(z), rank, 4), sp=sp4)
    res["infer_draw"] = glow.infer(cut(torch.from_numpy(mel), rank, 4),
                                   torch.Generator().manual_seed(5),
                                   sigma=INFER_SIGMA, sp=sp4)
    gen = Generator(HiFiGANConfig(**HIFIGAN), device="cpu")
    gen.load_state_dict(inputs["hifigan"])
    res["hifigan"] = gen(cut(torch.from_numpy(hmel), rank, 4), infer=True,
                         sp=sp4)
    dp, _, sp2 = meshes[(1, 2)]
    flow = flow_model("waveflow", inputs["waveflow"])
    mels = {"mels": flow_batch("waveflow")["mels"][:, :T_MEL]}
    b = sp2.shard_batch(dp.shard_batch(mels), {"mels": 32})
    with dp.scope():
        res["waveflow_infer"] = flow.infer(
            b["mels"], torch.Generator().manual_seed(6), sp=sp2)
    # the refusals, on every rank alike
    res["refusals"] = []
    try:
        make_mesh(1, 3)
    except SystemExit as e:
        res["refusals"].append(str(e))
    try:
        cli(flow_cli(inputs["map"], os.path.join(out, "refused"),
                     ["--sp", "2"], "segment_length=2688"))
    except SystemExit as e:
        res["refusals"].append(str(e))
    res["cli"] = {}
    for name, extra, hp in CLI_RUNS:
        trainer = cli(flow_cli(inputs["map"], os.path.join(out, name), extra,
                               hp))
        res["cli"][name] = {"steps": int(trainer.state.step),
                            "writes": trainer.logger._jsonl is not None}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()


def flow_cli(map_file, run, extra=(), hparams=""):
    return ["train", "--model", "waveglow", "--device", "cpu", "--filelist",
            map_file, "--run_dir", run, "--seed", "3", "--iters", "3",
            "--hparams", CLI_FLOW + ("," + hparams if hparams else ""),
            *extra]


# -- the module's run ------------------------------------------------------------

def jax_flow(name):
    """(the port's state dict, JAX's loss on the train batch) from JAX's
    init plus noise."""
    import jax
    import jax.numpy as jnp
    from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
    from cookietts_tpu.models.waveglow import WaveGlowConfig as JConfig
    from cookietts_tpu.models.waveglow import waveglow_loss as j_loss
    from cookietts_tpu_torch.convert.from_jax import waveglow_from_jax
    jm = JWaveGlow(JConfig(**FLOWS[name]))
    b = {k: jnp.asarray(v.numpy()) for k, v in flow_batch(name).items()}
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32),
        jm.init(jax.random.PRNGKey(0), b["audio"], b["mels"])["params"])
    loss = float(j_loss(jm.apply({"params": params}, b["audio"],
                                 b["mels"]))[0])
    port = WaveGlow(WaveGlowConfig(**FLOWS[name]), device="cpu")
    port.load_state_dict(waveglow_from_jax(params, port.cfg))
    return port.state_dict(), loss, (jm, params)


def jax_infer(jm, params, mel, z):
    import jax.numpy as jnp
    from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
    return np.asarray(jm.apply({"params": params}, jnp.asarray(z),
                               jnp.asarray(mel), method=JWaveGlow.inverse))


def jax_hifigan(mel):
    """(the port's state dict, JAX's audio) of test_tp.py's generator."""
    import jax
    import jax.numpy as jnp
    from cookietts_tpu.models.hifigan import Generator as JGenerator
    from cookietts_tpu.models.hifigan import HiFiGANConfig as JConfig
    from cookietts_tpu_torch.convert.from_jax import (
        hifigan_state_dict_from_jax)
    jg = JGenerator(JConfig(**HIFIGAN))
    v = jg.init(jax.random.PRNGKey(0), jnp.asarray(mel[:, :8]))
    return (hifigan_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, v["params"])), np.asarray(jg.apply(v, jnp.asarray(mel))))


def flow_map(root):
    """Four WAVs of exactly one segment: a segment takes no random start, so
    batch i is the same in a run resumed before it."""
    from cookietts_tpu_torch.data import audio_io
    os.makedirs(root)
    rng = np.random.default_rng(1)
    lines = []
    for i in range(4):
        t = np.arange(2560) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t)
                 + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        audio_io.save_wav(os.path.join(root, f"v{i}.wav"), audio, 16000)
        lines.append(f"{os.path.join(root, f'v{i}.wav')}||{i}")
    with open(os.path.join(root, "map.txt"), "w") as f:
        f.write("\n".join(lines))
    return os.path.join(root, "map.txt")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4-rank run and, meanwhile, the one-process runs and JAX."""
    out = str(tmp_path_factory.mktemp("sp"))
    mel, z, hmel = infer_inputs()
    flows = {n: jax_flow(n) for n in ("waveglow", "waveflow")}
    hsd, jax_audio = jax_hifigan(hmel)
    single = WaveGlow(WaveGlowConfig(**FLOWS["single"]), device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(8)
        for p in single.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    inputs = {"waveglow": flows["waveglow"][0],
              "waveflow": flows["waveflow"][0],
              "single": single.state_dict(), "hifigan": hsd,
              "infer": (mel, z, hmel),
              "map": flow_map(os.path.join(out, "wavs"))}
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    ranks = Ranks(__file__, out, WORLD)
    try:
        one = {"jax_loss": {n: f[1] for n, f in flows.items()},
               "jax_infer": jax_infer(*flows["waveglow"][2], mel, z),
               "jax_hifigan": jax_audio,
               "steps": {(n, me): flow_step(n, inputs[n], me)
                         for n, me, _ in STEPS}}
        glow = flow_model("waveglow", inputs["waveglow"])
        one["grads"] = loss_and_grads(glow, flow_batch("waveglow"))
        one["infer"] = glow.infer(torch.from_numpy(mel),
                                  z=torch.from_numpy(z))
        one["infer_draw"] = glow.infer(torch.from_numpy(mel),
                                       torch.Generator().manual_seed(5),
                                       sigma=INFER_SIGMA)
        gen = Generator(HiFiGANConfig(**HIFIGAN), device="cpu")
        gen.load_state_dict(hsd)
        one["hifigan"] = gen(torch.from_numpy(hmel), infer=True)
        one["waveflow_infer"] = flow_model(
            "waveflow", inputs["waveflow"]).infer(
            flow_batch("waveflow")["mels"][:, :T_MEL],
            torch.Generator().manual_seed(6))
        for name, _, hp in CLI_RUNS:
            cli(flow_cli(inputs["map"], os.path.join(out, name + "1"), [],
                         hp))
        ranks.wait()
    finally:
        ranks.close()
    # the sp run's checkpoint at 2 resumed in one process
    os.makedirs(os.path.join(out, "resumed"))
    for f in ("checkpoint_2", "checkpoint_2.json"):
        shutil.copy(os.path.join(out, "cli_sp", f),
                    os.path.join(out, "resumed", f))
    cli(flow_cli(inputs["map"], os.path.join(out, "resumed"),
                 ["--resume", os.path.join(out, "resumed", "checkpoint_2")]))
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


def test_the_mesh_is_dp_x_tp_x_sp_in_jax_order(run):
    """rank = (d tp + t) sp + s: the sp groups are consecutive ranks, the
    replica group (dp x sp) sums the gradients, the rows follow d."""
    for r, res in enumerate(run["ranks"]):
        assert res["rows"][(1, 2)] == (r // 2, 2, 4)
        assert res["rows"][(1, 4)] == (0, 1, 4)
        assert res["rows"][(2, 2)] == (0, 1, 2)
        assert res["sp_rank"] == {(1, 2): r % 2, (1, 4): r, (2, 2): r % 2}


@pytest.mark.parametrize("case", range(len(halo_cases())),
                         ids=[c[0] for c in halo_cases()])
def test_halo_pad_and_widen_match_the_unsharded_pad(run, case):
    """Each rank's conv output and input gradient are its run of the
    unsharded pad-and-conv's; widen adds the neighbours' steps, none past
    the utterance's ends."""
    _, sizes, left, right, d = halo_cases()[case]
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, sum(sizes), generator=g).requires_grad_(True)
    w = torch.randn(5, 3, (left + right) // d + 1, generator=g)
    y = F.conv1d(F.pad(x, (left, right)), w, dilation=d)
    y.backward(torch.randn(2, 5, sum(sizes), generator=g))
    offs = np.cumsum([0] + sizes)
    for r, res in enumerate(run["ranks"]):
        got_y, got_grad, (l, rr, wide) = res["halo"][case]
        run_ = slice(offs[r], offs[r + 1])
        torch.testing.assert_close(got_y, y.detach()[..., run_], atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(got_grad, x.grad[..., run_], atol=1e-5,
                                   rtol=1e-5)
        assert (l, rr) == (min(left, offs[r]),
                           min(right, offs[-1] - offs[r + 1]))
        assert torch.equal(wide, x.detach()[..., offs[r] - l:offs[r + 1] + rr])


@pytest.mark.parametrize("i", range(len(STEPS)),
                         ids=[f"{n}-{'memeff' if m else 'plain'}-tp{t}sp{s}"
                              for n, m, (t, s) in STEPS])
def test_flow_steps_match_one_process_and_jax(run, i):
    name, memory_efficient, _ = STEPS[i]
    want_m, want_state = run["one"]["steps"][(name, memory_efficient)]
    for res in run["ranks"]:
        got_m, got_state = res["steps"][i]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
        _hold_state(got_state, want_state, CTRL["lr"])
    if name in run["one"]["jax_loss"]:
        np.testing.assert_allclose(want_m["loss"],
                                   run["one"]["jax_loss"][name],
                                   rtol=LOSS_RTOL)


def test_the_halos_are_needed(run):
    """With the exchanges the sp 4 loss and gradients are one process's;
    with every run zero-padded at its ends they are not."""
    loss1, grads1 = run["one"]["grads"]
    for res in run["ranks"]:
        loss, grads = res["with_halo"]
        np.testing.assert_allclose(loss, loss1, rtol=LOSS_RTOL)
        for k, g in grads1.items():
            torch.testing.assert_close(grads[k], g, atol=1e-6, rtol=1e-4)
        loss_no, grads_no = res["no_halo"]
        assert abs(loss_no - loss1) > 1e-4 * abs(loss1)
        differ = [k for k, g in grads1.items()
                  if not torch.allclose(grads_no[k], g, atol=1e-6, rtol=1e-3)]
        assert "WN.0.in_layers.1.weight" in differ and "upsample.0.weight" \
            in differ, differ


def test_waveglow_infer_at_sp_4_matches_one_process_and_jax(run):
    one = run["one"]
    got = torch.cat([r["infer"] for r in run["ranks"]], 1)
    np.testing.assert_allclose(got.numpy(), one["infer"].numpy(), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), one["jax_infer"], atol=2e-4,
                               rtol=1e-4)
    # the sharded draw is the one-process draw
    drawn = torch.cat([r["infer_draw"] for r in run["ranks"]], 1)
    np.testing.assert_allclose(drawn.numpy(), one["infer_draw"].numpy(),
                               atol=2e-4, rtol=1e-4)
    cfg = WaveGlowConfig(**FLOWS["waveglow"])
    assert wn_reach(cfg) == 3 and upsample_reach(cfg)[0] > 1


def test_hifigan_at_sp_4_matches_one_process_and_jax(run):
    """The reach (19 frames) is wider than a run (16): the halo comes from
    two ranks."""
    gen = Generator(HiFiGANConfig(**HIFIGAN), device="cpu")
    assert gen.reach() > HIFIGAN_T_MEL // WORLD
    one = run["one"]
    got = torch.cat([r["hifigan"] for r in run["ranks"]], 1).numpy()
    np.testing.assert_allclose(got, one["hifigan"].numpy(), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got, one["jax_hifigan"], atol=2e-5, rtol=1e-4)


def test_waveflow_inverse_at_sp_2_matches_one_process(run):
    """dp 2 x sp 2: each rank holds its rows' run of the one-process audio
    (the time axis gathered for the row kernel, the draw one process's)."""
    want = run["one"]["waveflow_infer"]
    n = want.shape[1] // 2
    for r, res in enumerate(run["ranks"]):
        rows, s = slice(2 * (r // 2), 2 * (r // 2) + 2), r % 2
        np.testing.assert_allclose(res["waveflow_infer"].numpy(),
                                   want[rows, s * n:(s + 1) * n].numpy(),
                                   atol=2e-5, rtol=1e-5)


def _events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", [r[0] for r in CLI_RUNS])
def test_train_command_at_sp_2_matches_one_process(run, name):
    """WaveGlow at dp 2 x sp 2 and WaveFlow at tp 2 x sp 2 against the
    same command in one process; the first resumed in one process."""
    out = run["out"]
    two, one = os.path.join(out, name), os.path.join(out, name + "1")
    assert [r["cli"][name]["steps"] for r in run["ranks"]] == [3] * WORLD
    assert [r["cli"][name]["writes"] for r in run["ranks"]] == [True] + [
        False] * 3
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
    if name != "cli_sp":
        return
    # resumed at sp 1 from the sp run's checkpoint at 2: its next loss
    resumed = [e for e in _events(os.path.join(out, "resumed"))
               if e["prefix"] == "train"]
    want = [e for e in ev2 if e["prefix"] == "train" and e["step"] == 2]
    assert [e["step"] for e in resumed] == [2]
    np.testing.assert_allclose(resumed[0]["loss"], want[0]["loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("which", ["model", "world", "segment"])
def test_sp_refusals(run, which, tmp_path):
    if which == "model":
        with pytest.raises(SystemExit, match="only wired for --model "
                           "waveglow/waveflow"):
            cli(["train", "--device", "cpu", "--filelist", "x", "--sp", "2",
                 "--model", "tacotron2", "--run_dir", str(tmp_path)])
        return
    for res in run["ranks"]:
        world, segment = res["refusals"]
        if which == "world":
            assert "4 devices not divisible by tp*sp=3" in world, world
        else:
            assert "segment_length=2688" in segment and "sp * hop" in \
                segment, segment


if __name__ == "__main__":
    worker(sys.argv[1])
