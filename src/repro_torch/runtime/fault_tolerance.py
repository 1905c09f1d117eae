"""Fault tolerance for long-running training: the port of
``src/repro/runtime/fault_tolerance.py``.

  * **checkpoint/restart** — `TrainSupervisor` wraps the step loop with
    periodic async checkpoints and restart-from-latest; a failure injector
    simulates preemptions and the loop resumes losslessly (bitwise-equal
    state to an uninterrupted run, since steps are deterministic).
  * **elastic restore** — `elastic_restore` restores the latest checkpoint
    onto a device, or onto another mesh: a checkpoint saved from DTensors
    on N ranks (`Checkpointer.save` gathers each leaf, rank 0 writes)
    restores onto M ranks with new ``(mesh, placements)``.
  * **straggler detection** — the supervisor keeps an EWMA of the step
    time and flags a step slower than ``straggler_factor`` × it
    (`straggler_update`), so a launcher can act between checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten_with_paths


class SimulatedPreemption(RuntimeError):
    pass


def straggler_update(
    ewma: float | None, dt: float, factor: float
) -> tuple[float, bool]:
    """One step of straggler detection: compare ``dt`` against the EWMA of
    the steps *before* it, then fold it in.

    The comparison must use the previous EWMA: updating first lets the
    straggling step drag the average toward itself and dampen its own
    detection. Returns ``(new_ewma, straggling)``; the first step seeds the
    EWMA and is never flagged (no baseline to compare against).
    """
    straggling = ewma is not None and dt > factor * ewma
    new_ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
    return new_ewma, straggling


def _sync(state) -> None:
    """Wait for the device work behind ``state`` (the JAX package's
    ``block_until_ready``)."""
    leaves = flatten_with_paths(state)
    if leaves and leaves[0][1].is_cuda:
        torch.cuda.synchronize(leaves[0][1].device)


@dataclasses.dataclass
class TrainSupervisor:
    checkpointer: Checkpointer
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    # failure injection for tests: step -> exception factory
    fail_at: dict[int, Callable[[], Exception]] = dataclasses.field(default_factory=dict)

    def run(
        self,
        *,
        state: Any,                  # a tree of tensors, e.g. (params, opt_state)
        step_fn: Callable,           # (state, batch, step) -> (state, metrics)
        batch_fn: Callable,          # step -> batch (deterministic!)
        n_steps: int,
        start_step: int | None = None,
        device=None,
    ):
        """Run to ``n_steps``, resuming from the latest checkpoint if any
        (its leaves on ``device``, or where ``state``'s lie). Returns
        ``(state, history)``. Raises `SimulatedPreemption` out of the loop
        when injected — callers re-invoke ``run`` to model a restart. No
        exception leaves before the in-flight save is on disk, so a restart
        through a fresh `Checkpointer` finds it."""
        latest = self.checkpointer.latest_step()
        step = 0
        if start_step is not None:
            step = start_step
        elif latest is not None:
            state = self.checkpointer.restore(latest, state, device)
            step = latest
        history: list[dict] = []
        ewma = None
        try:
            while step < n_steps:
                if step in self.fail_at:
                    raise self.fail_at.pop(step)()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch_fn(step), step)
                _sync(state)
                dt = time.perf_counter() - t0
                ewma, straggling = straggler_update(ewma, dt, self.straggler_factor)
                history.append({"step": step, "dt": dt, "straggler_flag": straggling,
                                **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    self.checkpointer.save(step, state)
        finally:
            self.checkpointer.wait()
        return state, history


def elastic_restore(checkpointer: Checkpointer, like, device=None, *, shardings=None):
    """Restore the latest checkpoint in ``like``'s structure: onto another
    mesh with ``shardings`` (a tree of ``(mesh, placements)``, as the JAX
    package's restore onto new shardings after losing or gaining hosts),
    else onto ``device``. Returns ``(tree, step)``."""
    latest = checkpointer.latest_step()
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {checkpointer.directory}")
    return checkpointer.restore(latest, like, device, shardings=shardings), latest
