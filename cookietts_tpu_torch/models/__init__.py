"""Tacotron2 (+ SylpsNet; inference and the teacher-forced training
forward), the HiFi-GAN generator, the WaveGlow/WaveFlow inverse and the
spectral Denoiser."""
