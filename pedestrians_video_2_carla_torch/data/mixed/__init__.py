"""Mixed datamodules: several datamodules' batches interleaved."""
