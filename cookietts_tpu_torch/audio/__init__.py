"""Audio frontends of the port (cookietts_tpu/audio): the STFT pair, the
Tacotron mel frontend and the ISO 226 equal-loudness (de-)emphasis."""
