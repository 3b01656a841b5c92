"""The port's training runtime (cookietts_tpu/runtime): optimizers and the
plateau scheduler, train states (GAN too), checkpoints, live config,
metrics logging and the Trainer."""
