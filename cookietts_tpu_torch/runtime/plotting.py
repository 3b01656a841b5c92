"""Image rendering for training diagnostics (a copy of
cookietts_tpu/runtime/plotting.py).

Rebuild of the reference's plotting_utils.py (alignment / mel / gate
images for tensorboard, _2_ttm/tacotron2_tm/logger.py:64-114) producing
HWC uint8 numpy arrays via matplotlib's Agg backend. matplotlib is imported
when an image is drawn, so a machine without it imports this module and
fails only at the draw (the trainer catches that).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _fig_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    img = buf.reshape(h, w, 4)[..., :3].copy()
    import matplotlib.pyplot as plt
    plt.close(fig)
    return img


def plot_alignment(alignment: np.ndarray,
                   info: Optional[str] = None) -> np.ndarray:
    """[T_dec, T_enc] attention -> HWC image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep" + (f"\n{info}" if info else ""))
    ax.set_ylabel("Encoder timestep")
    fig.tight_layout()
    return _fig_to_array(fig)


def plot_spectrogram(mel: np.ndarray,
                     title: Optional[str] = None) -> np.ndarray:
    """[T, n_mel] log-mel -> HWC image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 3))
    im = ax.imshow(np.asarray(mel).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return _fig_to_array(fig)


def plot_gate(gate_targets: np.ndarray, gate_outputs: np.ndarray
              ) -> np.ndarray:
    """Gate target vs sigmoid(prediction) -> HWC image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 2.5))
    t = np.arange(len(gate_targets))
    ax.scatter(t, np.asarray(gate_targets), s=4, label="target",
               alpha=0.6)
    ax.scatter(t, 1.0 / (1.0 + np.exp(-np.asarray(gate_outputs))), s=4,
               label="predicted", alpha=0.6)
    ax.legend()
    ax.set_ylim(-0.05, 1.05)
    fig.tight_layout()
    return _fig_to_array(fig)
