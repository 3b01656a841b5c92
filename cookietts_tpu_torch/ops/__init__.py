"""Masking, the zoneout LSTM cell, location-sensitive attention, alignment
metrics, GTA mel alignment (``dtw``), mel-cepstral distortion (``mcd``) and
the hand-written Hopper kernels (``hopper_kernels``)."""
from .mcd import cepstrum_from_mel, f0_metrics, mcd, mcd_dtw  # noqa: F401
