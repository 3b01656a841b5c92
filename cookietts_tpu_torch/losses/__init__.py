"""Training losses of the port (cookietts_tpu/losses)."""
from .tacotron2_loss import (  # noqa: F401
    DEFAULT_LOSS_SCALARS,
    guided_attention_loss,
    tacotron2_loss,
)
