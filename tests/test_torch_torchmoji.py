"""The port's torchMoji against the JAX package's on the CPU.

The tokenizer gives the JAX tokenizer's ids on a sentence set (URLs,
mentions, digit runs, out-of-vocabulary words, hashtags, titles, maxlen).
The model runs at its published widths (2 x BiLSTM 512, 256 embedding) with
a small vocabulary: JAX params come across through ``convert.from_jax``,
and ragged rows give the JAX feature within 1e-5. The port's state dict also
goes through JAX's ``convert_torch_checkpoint`` (the converter of the
published pytorch_model.bin) and gives the same feature, so the published
file loads into the port as it is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models import torchmoji as jmoji

from cookietts_tpu_torch.convert.from_jax import torchmoji_state_dict_from_jax
from cookietts_tpu_torch.models import torchmoji as moji
from test_torch_threads import _one_thread  # noqa: F401


NB = 64
WORDS = ["i", "love", "this", "\U0001F604", "check", "out", "now", "hello",
         "how", "are", "you", "have", "apples", "and", "oranges", "don't",
         "#hashtag", ":)", ".", "!", "mr.", "stop"]
SENTENCES = [
    "I love this \U0001F604",
    "Check out https://example.com/page now",
    "hello @friend how are you",
    "I have 42 apples and 3.5 oranges",
    "visit www.test.org today",
    "numbers 123 456789",
    "don't stop believing",
    "#hashtag party :)",
    "Mr. unknownword!",
    "one two three four five six seven eight nine ten eleven twelve",
    "",
]


def _vocab():
    vocab = {t: i for i, t in enumerate(moji.SPECIAL_TOKENS)}
    vocab.update({w: len(vocab) + i for i, w in enumerate(WORDS)})
    return vocab


@pytest.mark.parametrize("maxlen", [5, 20])
def test_tokenize_matches_jax(maxlen):
    assert moji.SPECIAL_TOKENS == jmoji.SPECIAL_TOKENS
    vocab = _vocab()
    for s in SENTENCES:
        np.testing.assert_array_equal(moji.tokenize(s, vocab, maxlen),
                                      jmoji.tokenize(s, vocab, maxlen), err_msg=s)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jm = jmoji.TorchMoji(nb_tokens=NB)
    v = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))
    # non-trivial biases and a sharper attention than the init's
    params = jax.tree_util.tree_map(np.array, v["params"])
    for d in ("fwd", "bwd"):
        for i in (0, 1):
            b = params[f"lstm_{i}_{d}"]["ih"]["bias"]
            b[...] = rng.normal(0, 0.5, b.shape)
    params["attention_vector"] *= 20.0
    port = moji.TorchMoji(NB, device="cpu")
    port.load_state_dict(torchmoji_state_dict_from_jax(params))
    return jm, params, port


def test_torchmoji_matches_jax_ragged(models):
    jm, params, port = models
    rng = np.random.default_rng(1)
    lengths = [9, 1, 4, 6]
    ids = np.zeros((len(lengths), 9), np.int64)
    for row, n in enumerate(lengths):
        ids[row, :n] = rng.integers(1, NB, n)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (4, moji.FEATURE_DIM)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    # the published layout: the port's state dict through JAX's converter
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    p2 = jmoji.convert_torch_checkpoint(sd)
    np.testing.assert_allclose(
        got, np.asarray(jm.apply({"params": p2}, jnp.asarray(ids))),
        atol=1e-5, rtol=1e-5)
    # ...and padding never reaches a valid position
    with torch.no_grad():
        wider = port(torch.from_numpy(np.pad(ids, ((0, 0), (0, 5))))).numpy()
    np.testing.assert_allclose(wider, got, atol=1e-6, rtol=1e-6)


def test_encoder_and_published_checkpoint(models):
    """TorchMojiEncoder on a state dict with the published file's classifier
    keys (dropped on load) gives the model's feature of the tokenized text."""
    _, _, port = models
    vocab = _vocab()
    sd = dict(port.state_dict())
    sd["output_layer.0.weight"] = torch.zeros(64, moji.FEATURE_DIM)
    sd["output_layer.0.bias"] = torch.zeros(64)
    enc = moji.TorchMojiEncoder(vocab, sd, maxlen=20, device="cpu")
    text = "hello @friend how are you"
    with torch.no_grad():
        want = port(torch.from_numpy(moji.tokenize(text, vocab, 20)[None]))[0]
    got = enc(text)
    assert got.dtype == np.float32 and got.shape == (moji.FEATURE_DIM,)
    np.testing.assert_allclose(got, want.numpy(), atol=0, rtol=0)
    assert moji.hard_sigmoid(torch.tensor([-10.0, -2.5, 0.0, 2.5, 10.0])
                             ).tolist() == [0.0, 0.0, 0.5, 1.0, 1.0]
