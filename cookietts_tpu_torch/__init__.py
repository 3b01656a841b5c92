"""cookietts_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of cookietts_tpu.

The serving path text -> Tacotron2 -> HiFi-GAN or a flow vocoder (WaveGlow,
WaveFlow) with its spectral denoiser, inference only:

- ``text``     : grapheme/ARPAbet frontend (a copy of cookietts_tpu.text).
- ``ops``      : masking, the zoneout LSTM cell, location-sensitive attention,
                 alignment metrics, and the hand-written Hopper kernels
                 (``ops/hopper_kernels.py`` over ``csrc/*.cu``).
- ``audio``    : the matmul STFT and its inverse.
- ``models``   : Tacotron2 (+ SylpsNet), the HiFi-GAN generator, the
                 WaveGlow/WaveFlow inverse and the spectral Denoiser.
- ``pipeline`` : the T2S worker (segmentation, best-of-N, batched vocoding,
                 the denoiser hook, a flow vocoder as ``vocoder_fn``).
- ``convert``  : JAX param trees -> this package's state dicts.

Module paths mirror cookietts_tpu so each counterpart is easy to find. The
package imports torch, never jax, and nothing of cookietts_tpu. Entry points
run on the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"
