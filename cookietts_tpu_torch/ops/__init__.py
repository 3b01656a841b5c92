"""Masking, the zoneout LSTM cell, location-sensitive attention, alignment
metrics, GTA mel alignment (``dtw``) and the hand-written Hopper kernels
(``hopper_kernels``)."""
