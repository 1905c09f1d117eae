"""Step builders of the port, as ``src/repro/train/``: serving entry points
so far (training is a later slice)."""
