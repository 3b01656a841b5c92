"""Masking, the zoneout LSTM cell, location-sensitive attention, alignment
metrics and the hand-written Hopper kernels (``hopper_kernels``)."""
