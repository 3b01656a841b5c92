"""The backward of the port's two training kernels against JAX.

``attention_step`` and ``lstm_gates`` run forward under autograd in
training; their backward is autograd of the plain version recomputed from
the saved inputs (``hk.attention_step_vjp`` / ``hk.lstm_gates_vjp``), as the
JAX package's ``custom_vjp`` backward is the VJP of its plain expression.
Here those functions (the code the autograd Functions' backward runs on the
card) take CPU tensors and are held against ``jax.vjp`` of
``fused_attention`` / ``fused_lstm_gates``, whose forward runs the Pallas
kernel in interpret mode on the CPU, as tests/test_pallas.py runs it.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.ops.pallas_kernels import (NEG, fused_attention,
                                              fused_lstm_gates)
from cookietts_tpu_torch.ops import hopper_kernels as hk
from test_torch_threads import _one_thread  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _attention_inputs(B, T, A, D, lengths, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return (f(B, A, sc=0.5), f(B, T, A, sc=0.5), f(B, T, A, sc=0.5),
            f(A, sc=A ** -0.5), f(B, T, D), mask)


@pytest.mark.parametrize("lengths", [(37, 28, 17), (37, 1, 20)],
                         ids=["masked_tails", "all_but_one_masked"])
def test_attention_step_vjp_matches_jax(lengths):
    args = _attention_inputs(3, 37, 48, 56, lengths, seed=0)
    rng = np.random.default_rng(1)
    g_ctx = rng.standard_normal((3, 56)).astype(np.float32)
    g_w = rng.standard_normal((3, 37)).astype(np.float32)
    mask = jnp.asarray(args[5])
    _, vjp = jax.vjp(lambda *a: fused_attention(*a, mask),
                     *map(jnp.asarray, args[:5]))
    want = vjp((jnp.asarray(g_ctx), jnp.asarray(g_w)))
    t = [torch.from_numpy(a) for a in args]
    got = hk.attention_step_vjp(*t, None, torch.from_numpy(g_ctx),
                                torch.from_numpy(g_w))
    assert got[5] is None                      # no scale, no gradient
    for g, w in zip(got[:5], want):
        _close(g, w)


def test_attention_step_vjp_learned_temperature():
    """A learned softmax temperature scales the energies (the JAX module's
    non-Pallas branch); the scale gets its gradient too."""
    args = _attention_inputs(2, 19, 16, 24, (19, 9), seed=3)
    scale = np.array([0.7], np.float32)
    rng = np.random.default_rng(4)
    g_ctx = rng.standard_normal((2, 24)).astype(np.float32)
    g_w = rng.standard_normal((2, 19)).astype(np.float32)
    mask = jnp.asarray(args[5])

    def ref(qp, lp, mp, v, memory, s):
        e = jnp.einsum("bta,a->bt", jnp.tanh(qp[:, None, :] + lp + mp), v) * s
        w = jax.nn.softmax(jnp.where(mask, e, NEG), axis=-1)
        return jnp.einsum("bt,btd->bd", w, memory), w

    _, vjp = jax.vjp(ref, *map(jnp.asarray, args[:5] + (scale,)))
    want = vjp((jnp.asarray(g_ctx), jnp.asarray(g_w)))
    t = [torch.from_numpy(a) for a in args]
    got = hk.attention_step_vjp(*t, torch.from_numpy(scale),
                                torch.from_numpy(g_ctx), torch.from_numpy(g_w))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("B", [3, 35], ids=["B3", "B35_past_a_row_group"])
def test_lstm_gates_vjp_matches_jax(B):
    """F and H 128-aligned, so JAX's forward is the Pallas kernel; B = 35 is
    not a multiple of the CUDA kernel's 32-row group."""
    rng = np.random.default_rng(B)
    F, H = 256, 128
    xh = (rng.standard_normal((B, F)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((F, 4 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.05).astype(np.float32)
    c = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    g_c = rng.standard_normal((B, H)).astype(np.float32)
    g_h = rng.standard_normal((B, H)).astype(np.float32)
    _, vjp = jax.vjp(fused_lstm_gates, *map(jnp.asarray, (xh, w, b, c)))
    want = vjp((jnp.asarray(g_c), jnp.asarray(g_h)))
    got = hk.lstm_gates_vjp(*map(torch.from_numpy, (xh, w, b, c, g_c, g_h)))
    for g, ref in zip(got, want):
        _close(g, ref)


def _ctx(saved, needs):
    return types.SimpleNamespace(saved_tensors=saved, needs_input_grad=needs)


def test_autograd_functions_backward_route_gradients():
    """The Functions' backward (run on the card after a kernel forward)
    returns one gradient per forward input, in order, None for the mask,
    the plan and what needs none."""
    args = [torch.from_numpy(a) for a in
            _attention_inputs(2, 11, 8, 12, (11, 4), seed=5)]
    scale = torch.tensor([1.3])
    g = (torch.randn(2, 12), torch.randn(2, 11))
    needs = (True, True, False, True, True, False, True, False)
    out = hk._attention_step_backward(_ctx((*args, scale), needs), *g)
    want = hk.attention_step_vjp(*args, scale, *g)
    assert len(out) == 8 and out[2] is None and out[5] is None \
        and out[7] is None
    for i, j in ((0, 0), (1, 1), (3, 3), (4, 4), (6, 5)):
        torch.testing.assert_close(out[i], want[j])

    xh, w, b, c = torch.randn(3, 20), torch.randn(20, 32), torch.randn(32), \
        torch.randn(3, 8)
    gc, gh = torch.randn(3, 8), torch.randn(3, 8)
    out = hk._lstm_gates_backward(_ctx((xh, w, b, c), (False, True, True, True)),
                                 gc, gh)
    assert len(out) == 4 and out[0] is None
    leaves = [t.clone().requires_grad_(True) for t in (w, b, c)]
    ref = torch.autograd.grad(hk.lstm_gates_plain(xh, *leaves), leaves,
                              (gc, gh))
    for got, r in zip(out[1:], ref):
        torch.testing.assert_close(got, r)


def test_inference_only_kernels_say_so():
    with pytest.raises(NotImplementedError, match="JAX package has none"):
        hk._no_backward(None, torch.zeros(1))
