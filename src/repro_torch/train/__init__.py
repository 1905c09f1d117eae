"""Step builders of the port, as ``src/repro/train/``: the training step
(`make_train_step`, `loss_for`) and the serving entry points
(`make_serve_fns`)."""
from repro_torch.train.step import loss_for, make_serve_fns, make_train_step

__all__ = ["loss_for", "make_serve_fns", "make_train_step"]
