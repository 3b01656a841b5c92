"""cookietts_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of cookietts_tpu.

The serving path text -> Tacotron2 -> HiFi-GAN or a flow vocoder (WaveGlow,
WaveFlow) with its spectral denoiser, and Tacotron2, HiFi-GAN and
WaveGlow/WaveFlow training (``python -m cookietts_tpu_torch train``):

- ``text``     : grapheme/ARPAbet frontend (a copy of cookietts_tpu.text).
- ``ops``      : masking, the zoneout LSTM cell, location-sensitive attention,
                 alignment metrics, and the hand-written Hopper kernels
                 (``ops/hopper_kernels.py`` over ``csrc/*.cu``).
- ``audio``    : the matmul STFT and its inverse, the mel frontend.
- ``models``   : Tacotron2 (+ SylpsNet), the HiFi-GAN generator and
                 discriminators, WaveGlow/WaveFlow (training forward and
                 inverse) and the spectral Denoiser.
- ``pipeline`` : the T2S worker (segmentation, best-of-N, batched vocoding,
                 the denoiser hook, a flow vocoder as ``vocoder_fn``).
- ``convert``  : JAX param trees -> this package's state dicts.
- ``data``, ``losses``, ``runtime``, ``cli``: the training paths (the
                 Tacotron2 dataset with TBPTT batching, the vocoders'
                 Mel2Samp, the losses, Adam and LAMB, checkpoints, the
                 Trainer, the ``train`` command).

Module paths mirror cookietts_tpu so each counterpart is easy to find. The
package imports torch, never jax, and nothing of cookietts_tpu. Entry points
run on the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"
