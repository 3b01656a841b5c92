"""Tacotron2 (+ SylpsNet) and the HiFi-GAN generator, inference."""
