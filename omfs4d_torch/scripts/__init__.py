"""Command-line tools of the port that are not part of the pipeline
(`python -m omfs4d_torch.scripts.<name>`); the counterparts of `scripts/`."""
