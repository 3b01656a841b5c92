"""The port's training runtime (cookietts_tpu/runtime): optimizer, train
state, checkpoints, live config, metrics logging and the Trainer."""
