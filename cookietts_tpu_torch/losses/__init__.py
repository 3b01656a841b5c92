"""Training losses of the port (cookietts_tpu/losses). UnTTS's flow NLL
lives next to its model (``models.untts.untts_loss``) and is re-exported
here lazily, as JAX does, so that importing the losses does not import the
model."""
from .tacotron2_loss import (  # noqa: F401
    DEFAULT_LOSS_SCALARS,
    guided_attention_loss,
    tacotron2_loss,
)


def __getattr__(name):
    if name == "untts_loss":
        from ..models.untts import untts_loss
        return untts_loss
    raise AttributeError(name)
