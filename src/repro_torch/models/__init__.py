"""Model families of the port, as ``src/repro/models/``: xDeepFM so far."""
