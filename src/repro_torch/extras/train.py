"""Training launcher: ``python -m repro_torch.extras.train --arch <id>
[--full] [--steps N] [--batch B] [--seq S] [--microbatches n] [--ckpt-dir D]
[--resume] [--seed s] [--device cpu]``.

The port of ``src/repro/extras/train.py``, on one device (the card unless
``--device`` names another). Wires: the config (``--arch``, its smoke
config unless ``--full``) → `data/pipeline.py` batches →
`train.make_train_step` → AdamW → `checkpoint.Checkpointer` →
`runtime.TrainSupervisor`. A GNN trains on one full-graph batch of a
512-node R-MAT, as there.
"""
from __future__ import annotations

import argparse
import pathlib
import shutil

import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch import configs
from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.core.backend import resolve_device
from repro_torch.data import pipeline as data
from repro_torch.graphstore import generators
from repro_torch.models.gnn import GNN
from repro_torch.models.recsys import XDeepFM
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import TrainSupervisor
from repro_torch.train import make_train_step
from repro_torch.train.step import supervised

# the families the launcher trains; ``--arch`` is a registered arch id
TRAINED_FAMILIES = ("lm", "gnn", "recsys")


def trainable_archs() -> list[str]:
    return sorted(a for a, e in configs.all_archs().items() if e.family in TRAINED_FAMILIES)


def build(arch: str, *, smoke: bool, batch: int, seq: int, seed: int, device=None):
    """``(cfg, model, batch_fn)``: the model drawn from ``seed`` on
    ``device``, and ``batch_fn(step)`` the step's numpy batch."""
    if arch not in trainable_archs():
        raise SystemExit(f"unknown --arch {arch!r}; one of {trainable_archs()}")
    entry = configs.get(arch)
    cfg = entry.smoke() if smoke else entry.config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if isinstance(cfg, LMConfig):
        model = Transformer(cfg, generator=gen, device=dev)
        batch_fn = lambda step: data.lm_batch(cfg, batch, seq, seed=seed, step=step)  # noqa: E731
    elif isinstance(cfg, GNNConfig):
        model = GNN(cfg, generator=gen, device=dev)
        g = generators.rmat(512, 2048, 8, seed=seed)
        graph = data.gnn_full_batch(cfg, g, n_classes=cfg.n_classes, seed=seed)
        batch_fn = lambda step: {"graph": graph}  # noqa: E731
    elif isinstance(cfg, RecSysConfig):
        model = XDeepFM(cfg, generator=gen, device=dev)
        batch_fn = lambda step: data.recsys_batch(cfg, batch, seed=seed, step=step)  # noqa: E731
    else:
        raise SystemExit(f"{arch}: not a model the launcher trains")
    return cfg, model, batch_fn


def main(argv: list[str] | None = None) -> list[dict]:
    """Train as the arguments say; returns the supervisor's history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    cfg, model, batch_fn = build(args.arch, smoke=args.smoke, batch=args.batch,
                                 seq=args.seq, seed=args.seed, device=args.device)
    opt_cfg = optim.AdamWConfig(lr=args.lr)
    step_fn, params = supervised(model, make_train_step(
        cfg, opt_cfg, total_steps=args.steps, microbatches=args.microbatches))

    ckpt = Checkpointer(args.ckpt_dir)
    if not args.resume:
        for p in sorted(pathlib.Path(args.ckpt_dir).glob("step_*")):
            shutil.rmtree(p)
    sup = TrainSupervisor(ckpt, ckpt_every=args.ckpt_every)
    _, history = sup.run(state=(params, optim.init(opt_cfg, params)), step_fn=step_fn,
                         batch_fn=batch_fn, n_steps=args.steps)
    for h in history[:: max(1, len(history) // 10)]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"grad_norm {h['grad_norm']:.3f}  {h['dt'] * 1e3:.0f} ms")
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
