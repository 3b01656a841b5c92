"""attention_step v3's launch plan, and its algorithm emulated in numpy
against the JAX attention step, on the CPU.

The CUDA kernel (csrc/attention_step.cu) runs only on the card, where
``chip_smoke.py`` holds it against ``attention_step_plain``. Here
``emulate_v3`` follows the kernel step by step in float32: each block of a
batch row's cluster lists the admitted rows of its chunk, reads those rows
and no other in stages of the plan's size, keeps a running max and sum and a
rescaled partial context, and the cluster combines the blocks' statistics
and sums the partials in rank order; an empty mask row takes the second pass over
every row. Masked rows of lp, mp and memory are poisoned with NaN before
they reach the emulation, so any read of one would show.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from cookietts_tpu.ops.pallas_kernels import attention_step as j_attention_step

from cookietts_tpu_torch.ops import hopper_kernels as hk
from test_torch_threads import _one_thread  # noqa: F401


F32 = np.float32
PHASE3 = [(B, T, 192, 512) for B in (1, 4, 32) for T in (64, 128, 384)]
EDGES = [(1, 1, 192, 512),        # one row
         (4, 37, 192, 512),       # T not a multiple of a block's rows
         (1, 4096, 192, 512),     # beyond what one cluster's shared memory holds
         (4, 64, 192, 1313),      # use_memory_bottleneck=False: D = 1313
         (32, 64, 128, 512), (4, 300, 128, 1313), (128, 900, 192, 512)]


@pytest.mark.parametrize("B,T,A,D", PHASE3 + EDGES,
                         ids=lambda v: str(v))
def test_attention_step_plan_covers_rows_once_and_fits(B, T, A, D):
    plan = hk.attention_step_plan(B, T, A, D)
    S, R = plan.cluster, plan.rows
    assert 1 <= S <= hk.ATTN_CLUSTER_MAX
    covered = np.zeros(T, np.int64)
    for r in range(S):
        rows = slice(r * R, min(T, (r + 1) * R))
        assert rows.start < T, "a block without rows"
        covered[rows] += 1
    assert (covered == 1).all()
    assert plan.smem == hk.attention_step_smem(A, D, R, plan.stage_rows)
    assert plan.smem <= hk.SMEM_MAX
    # a stage holds the block's rows, up to 48, or as many as fit
    assert (plan.stage_rows == min(R, hk.ATTN_STAGE_ROWS) or hk.attention_step_smem(
        A, D, R, plan.stage_rows + 1) > hk.SMEM_MAX)
    assert plan.stages == -(-R // plan.stage_rows)
    assert S == 1 or hk.clusters_fit(B, S, plan.smem)    # one wave
    if B <= 4 and 64 <= T <= 384 and D == 512:
        assert S == hk.ATTN_CLUSTER_MAX       # the main path's: 16 blocks a row


def test_attention_step_plan_forced_and_refused():
    plan = hk.attention_step_plan(4, 128, 192, 512, cluster=2, stage_rows=5)
    assert (plan.cluster, plan.rows, plan.stage_rows, plan.stages) == (2, 64, 5, 13)
    assert hk.attention_step_plan(4, 128, 192, 512, cluster=4,
                                  stage_rows=99).stages == 1
    # B=32, T=384: clusters of 8 holding a window in one stage would not
    # all be resident; clusters of 2 are
    assert hk.attention_step_plan(32, 384, 192, 512).ints() == (2, 192, 48)
    for bad in (dict(B=0), dict(cluster=17), dict(A=40000, D=40000)):
        args = dict(B=4, T=64, A=192, D=512) | bad
        with pytest.raises(ValueError):
            hk.attention_step_plan(**args)


def emulate_v3(qp, lp, mp, v, mem, mask, scale, plan):
    """attention_step.cu v3 in float32 numpy, block by block (module doc)."""
    B, T, A = lp.shape
    D = mem.shape[2]
    S, R, sr = plan.cluster, plan.rows, plan.stage_rows
    sc = F32(1.0 if scale is None else scale)
    ctx, w = np.zeros((B, D), F32), np.zeros((B, T), F32)
    for b in range(B):
        stats, parts, energies = [], [], []
        for r in range(S):
            rows = np.arange(r * R, min(T, (r + 1) * R))
            adm = rows[mask[b, rows]]
            e = np.full(len(rows), F32(hk.NEG), F32)
            m_run, l_run, acc = F32(-np.inf), F32(0), np.zeros(D, F32)
            for s0 in range(0, len(adm), sr):
                st = adm[s0:s0 + sr]
                e_st = (np.tanh(qp[b] + lp[b, st] + mp[b, st]) @ v) * sc
                e[st - r * R] = e_st
                m_new = max(m_run, e_st.max())
                p = np.exp(e_st - m_new)
                corr = F32(0) if m_run == -np.inf else np.exp(m_run - m_new)
                l_run = l_run * corr + p.sum(dtype=F32)
                acc = acc * corr + p @ mem[b, st]
                m_run = m_new
            stats.append((m_run, l_run))
            parts.append(acc)
            energies.append(e)
        M = max(m for m, _ in stats)
        if M == -np.inf:                 # empty mask row: the second pass
            parts = [mem[b, r * R:min(T, (r + 1) * R)].sum(0, dtype=F32)
                     for r in range(S)]
            fac = [F32(1.0 / T)] * S
            w[b] = F32(1.0 / T)
        else:
            f = [F32(0) if m == -np.inf else np.exp(m - M) for m, _ in stats]
            L = np.sum(np.array([l * fr for (_, l), fr in zip(stats, f)], F32))
            fac = [fr / L for fr in f]
            for r, e in enumerate(energies):
                w[b, r * R:r * R + len(e)] = np.exp(e - M) / L
        for r in range(S):                # rank order
            ctx[b] += fac[r] * parts[r]
    return ctx, w


def _inputs(case):
    B, T, A, D = 3, 40, 24, (37 if case == "odd_D" else 20)
    rng = np.random.default_rng(len(case))
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(F32)
    idx = np.arange(T)[None, :]
    if case == "full":
        mask = np.ones((B, T), bool)
    else:                                  # window of 2 * 4 + 1 rows and lengths
        lengths = np.array([T, T - 7, T - 13])[:, None]
        start = np.array([0, T - 7 - 9, 11])[:, None]   # both edges and inside
        mask = (idx < lengths) & (idx >= start) & (idx <= start + 8)
    if case == "empty_row":
        mask[1] = False
    return (f(B, A, k=0.5), f(B, T, A, k=0.5), f(B, T, A, k=0.5),
            f(A, k=A ** -0.5), f(B, T, D), mask)


CASES = ["window", "empty_row", "full", "scaled", "odd_D"]


@functools.lru_cache(maxsize=None)
def _jax_reference(case, use_pallas):
    qp, lp, mp, v, mem, mask = _inputs(case)
    # an energy scale s equals the JAX step with v scaled by s; the empty
    # row's T (40) is a multiple of 8, so the Pallas kernel's padded rows
    # take no share of its uniform weights
    v_j = v * F32(1.7) if case == "scaled" else v
    ctx, w = j_attention_step(*(jnp.asarray(a) for a in
                                (qp, lp, mp, v_j, mem, mask)),
                              use_pallas=use_pallas)
    return np.asarray(ctx), np.asarray(w)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("forced", [None, (2, 3), (5, 1)],
                         ids=["plan", "cluster2-stage3", "cluster5-stage1"])
@pytest.mark.parametrize("case", CASES)
def test_v3_algorithm_matches_jax(case, forced, use_pallas):
    qp, lp, mp, v, mem, mask = _inputs(case)
    B, T, A = lp.shape
    plan = hk.attention_step_plan(B, T, A, mem.shape[2], *(forced or ()))
    if forced:
        assert plan.stages > 1
    if case != "empty_row":               # v3 never reads a masked row
        lp, mp, mem = (np.where(mask[..., None], a, F32(np.nan))
                       for a in (lp, mp, mem))
    ctx, w = emulate_v3(qp, lp, mp, v, mem, mask,
                        1.7 if case == "scaled" else None, plan)
    ctx_r, w_r = _jax_reference(case, use_pallas)
    np.testing.assert_allclose(w, w_r, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ctx, ctx_r, atol=2e-4, rtol=1e-3)
    assert (w[~mask] == 0).all() or case == "empty_row"
    if case == "empty_row":
        np.testing.assert_array_equal(w[1], F32(1.0 / T))
