"""The T2S serving worker."""
