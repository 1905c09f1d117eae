"""Input pipelines of the port (numpy, seeded), as ``src/repro/data/``."""
