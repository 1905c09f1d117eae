"""Train a small LM with the PyTorch port's full loop, on the card: AdamW +
cosine schedule, checkpoints, restart on failure.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]

The model is the JAX example's (4 layers, d 256, 8 query heads on 4 kv
heads of 32, float32). Its prefill and training attention run the
``flash_attention`` kernel of the route its dtype and head dims select;
the example prints that route and, on the card, its launches. Without a
GPU the default device raises; nothing falls back to the CPU.
"""
import argparse
import shutil

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import LMConfig
from repro_torch.core.backend import resolve_device
from repro_torch.data.pipeline import lm_batch
from repro_torch.extras.flash_attention import flash_attention as fa
from repro_torch.kernels import cuda
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import SimulatedPreemption, TrainSupervisor
from repro_torch.train import make_train_step
from repro_torch.train.step import supervised


def main(argv=None) -> dict:
    """Train; returns the history, the attention route, its kernel's symbol
    and its launches."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="build/torch_example_ckpt")
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: raise now, before any set-up
    shutil.rmtree(args.ckpt, ignore_errors=True)

    cfg = LMConfig(
        name="lm-demo", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        d_head=32, d_ff=1024, vocab_size=4096, dtype="float32",
    )
    model = Transformer(cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params on {model.device} (kernels={model.kernels.name!r})")
    shape = torch.empty((1, 1, cfg.n_heads, cfg.d_head), dtype=torch.float32, device="meta")
    kv = torch.empty((1, 1, cfg.n_kv_heads, cfg.d_head), dtype=torch.float32, device="meta")
    route = fa.route(shape, kv, kv)
    symbol = fa.ROUTES[route].symbol
    print(f"attention route for float32, head dim {cfg.d_head}, {cfg.n_heads} on "
          f"{cfg.n_kv_heads} heads: {route!r} ({symbol})")

    opt_cfg = optim.AdamWConfig(lr=1e-3)
    step_fn, params = supervised(
        model, make_train_step(cfg, opt_cfg, total_steps=args.steps, warmup=20))

    def batch_fn(step):
        return lm_batch(cfg, args.batch, args.seq, seed=0, step=step)

    before = cuda.launch_counts()[symbol]
    sup = TrainSupervisor(
        Checkpointer(args.ckpt), ckpt_every=50,
        fail_at={args.steps // 2: lambda: SimulatedPreemption("injected")}
        if args.inject_failure
        else {},
    )
    state = (params, optim.init(opt_cfg, params))
    try:
        _, hist = sup.run(state=state, step_fn=step_fn, batch_fn=batch_fn, n_steps=args.steps)
    except SimulatedPreemption:
        print("!! preempted — restarting from latest checkpoint")
        _, hist = sup.run(state=state, step_fn=step_fn, batch_fn=batch_fn, n_steps=args.steps)
    launches = cuda.launch_counts()[symbol] - before
    print(f"{symbol}: {launches} launches over {len(hist)} steps")
    for h in hist[:: max(1, len(hist) // 8)]:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  {h['dt'] * 1e3:5.0f} ms")
    print(f"final loss {hist[-1]['loss']:.4f} (started ~{np.log(4096):.2f} = ln V)")
    if args.steps >= 100:  # a shorter run has barely left its 20-step warmup
        assert hist[-1]["loss"] < np.log(4096), "no learning happened?"
    return {"history": hist, "route": route, "symbol": symbol, "launches": launches}


if __name__ == "__main__":
    main()
