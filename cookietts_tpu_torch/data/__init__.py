"""Training data of the port (cookietts_tpu/data): filelists and dataset
metadata, host-side audio I/O, the Tacotron2 dataset with TBPTT batching,
the vocoders' Mel2Samp, background prefetch, curation and the synthetic
evidence corpus."""
