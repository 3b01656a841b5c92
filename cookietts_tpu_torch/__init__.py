"""cookietts_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of cookietts_tpu.

The serving path text -> Tacotron2 -> HiFi-GAN, inference only:

- ``text``     : grapheme/ARPAbet frontend (a copy of cookietts_tpu.text).
- ``ops``      : masking, the zoneout LSTM cell, location-sensitive attention,
                 alignment metrics, and the hand-written Hopper kernels
                 (``ops/hopper_kernels.py`` over ``csrc/*.cu``).
- ``models``   : Tacotron2 (+ SylpsNet) and the HiFi-GAN generator.
- ``pipeline`` : the T2S worker (segmentation, best-of-N, batched vocoding).
- ``convert``  : JAX param trees -> this package's state dicts.

Module paths mirror cookietts_tpu so each counterpart is easy to find. The
package imports torch, never jax, and nothing of cookietts_tpu. Entry points
run on the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
