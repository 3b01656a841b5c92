"""Audio frontends of the port (cookietts_tpu/audio): the STFT pair."""
