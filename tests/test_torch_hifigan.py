"""The PyTorch port's HiFi-GAN generator against the JAX generator on the CPU,
and the weights carried across in both directions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.convert import convert_hifigan_state_dict
from cookietts_tpu.models.hifigan import (Generator as JGenerator,
                                         HiFiGANConfig as JConfig,
                                         _fold_wn_conv)

from cookietts_tpu_torch.convert.from_jax import hifigan_state_dict_from_jax
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig

# the bench-serving generator's upsampling (hop 512), narrow and with two
# MRF kernel sizes so the MRF mean is exercised
TINY = dict(n_mel_channels=80, resblock_kernel_sizes=(3, 5),
            resblock_dilations=((1, 3), (1, 2)), upsample_rates=(8, 8, 4, 2),
            upsample_kernel_sizes=(16, 16, 8, 4), upsample_initial_channel=32)


@pytest.fixture(scope="module")
def gens():
    torch.backends.cudnn.allow_tf32 = False
    jg = JGenerator(JConfig(**TINY))
    mel = np.random.default_rng(0).normal(-4, 2, (2, 20, 80)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray,
                               jg.init(jax.random.PRNGKey(0), jnp.asarray(mel)))
    port = Generator(HiFiGANConfig(**TINY), device="cpu")
    port.load_state_dict(hifigan_state_dict_from_jax(v["params"]))
    return jg, v, port, mel


def test_generator_matches_jax(gens):
    jg, v, port, mel = gens
    ref = np.asarray(jg.apply(v, jnp.asarray(mel)))
    audio = port(torch.from_numpy(mel)).numpy()
    assert audio.shape == ref.shape == (2, 20 * 512)
    np.testing.assert_allclose(audio, ref, atol=1e-5, rtol=0)


def test_weight_norm_pairs_fold_at_load(gens):
    """A reference checkpoint stores weight_g/weight_v; loading folds them."""
    _, _, port, mel = gens
    sd = {}
    for k, t in port.state_dict().items():
        if k.endswith(".weight"):
            norm = t.flatten(1).norm(dim=1).reshape(-1, *[1] * (t.dim() - 1))
            sd[k[:-len("weight")] + "weight_v"] = t * 3.0
            sd[k[:-len("weight")] + "weight_g"] = norm
        else:
            sd[k] = t
    other = Generator(HiFiGANConfig(**TINY), device="cpu")
    other.load_state_dict(sd)
    np.testing.assert_allclose(other(torch.from_numpy(mel)).numpy(),
                               port(torch.from_numpy(mel)).numpy(),
                               atol=1e-6, rtol=0)


def test_weights_round_trip(gens):
    """JAX -> port state dict -> cookietts_tpu.convert -> JAX gives back the
    same effective (weight-norm folded) kernels and the same biases."""
    _, v, _, _ = gens
    p = v["params"]
    back, _ = convert_hifigan_state_dict(hifigan_state_dict_from_jax(p))
    pairs = [("conv_pre", "Conv_0", p, back), ("conv_post", "Conv_1", p, back)]
    pairs += [(f"up{i}", f"ConvTranspose_{i}", p, back) for i in range(4)]
    for i in range(4):
        for j in range(2):
            rb = f"resblock{i}_{j}"
            for m in range(2):
                pairs += [(f"conv1_{m}", f"Conv_{2 * m}", p[rb], back[rb]),
                          (f"conv2_{m}", f"Conv_{2 * m + 1}", p[rb], back[rb])]
    for wrapper, conv, a, b in pairs:
        w_a, b_a = _fold_wn_conv(a, wrapper, conv)
        w_b, b_b = _fold_wn_conv(b, wrapper, conv)
        np.testing.assert_allclose(np.asarray(w_b), np.asarray(w_a),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(b_b), np.asarray(b_a))
