"""Fault tolerance: heartbeats, failure injection and the checkpoint-restart
loop.  Port of ``repro.train.ft``, over the port's ``train/checkpoint.py``.

``run_with_recovery`` steps a training function, checkpoints every
``ckpt_every`` steps, and on an (injected) failure restores the parameters
and optimizer state from the last checkpoint and replays from its step.
The data stream is a pure function of the step (``data/pipeline.py``), so a
replayed step sees the batch it saw the first time.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass, field

from repro_torch.train import checkpoint


@dataclass
class Heartbeat:
    """Last-seen timestamps per worker id."""

    timeout_s: float = 30.0
    last_seen: dict[int, float] = field(default_factory=dict)

    def beat(self, worker: int, now: float | None = None) -> None:
        self.last_seen[worker] = time.monotonic() if now is None else now

    def dead_workers(self, now: float | None = None) -> list:
        now = time.monotonic() if now is None else now
        return [w for w, t in self.last_seen.items() if now - t > self.timeout_s]


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given step numbers
    (each once)."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.injected = []

    def check(self, step: int) -> bool:
        if step in self.fail_at:
            self.fail_at.remove(step)
            self.injected.append(step)
            return True
        return False


def run_with_recovery(
    step_fn: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
    batches: Callable,  # (step) -> batch
    params,
    opt_state,
    *,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    injector: FailureInjector | None = None,
    on_metrics: Callable | None = None,
):
    """Train for ``n_steps`` surviving failures.  Returns ``(params,
    opt_state, history)``: ``history["loss"]`` holds every step's loss as a
    Python float (one ``.item()`` a step, replayed steps included) and
    ``history["recoveries"]`` a ``{"failed_at", "resumed_from"}`` a
    failure.  The final state is checkpointed at ``n_steps``; where
    ``ckpt_every`` divides it, the loop's last save is that checkpoint (the
    reference writes the same state a second time; at full width a save is
    tens of GB)."""
    history = {"loss": [], "recoveries": []}
    state = {"params": params, "opt_state": opt_state}
    checkpoint.save(ckpt_dir, state, step=0)

    step = 0
    while step < n_steps:
        if injector is not None and injector.check(step):
            # Simulated node failure: wipe live state, restore from disk
            # (into the failed state's tensors, in place).
            manifest = checkpoint.load_manifest(ckpt_dir)
            state = checkpoint.restore(ckpt_dir, state)
            history["recoveries"].append({"failed_at": step, "resumed_from": manifest["step"]})
            step = manifest["step"]
            continue

        params, opt_state, metrics = step_fn(state["params"], state["opt_state"], batches(step))
        state = {"params": params, "opt_state": opt_state}
        history["loss"].append(metrics["loss"].item())
        if on_metrics is not None:
            on_metrics(step, metrics)
        step += 1
        if step % ckpt_every == 0:
            checkpoint.save(ckpt_dir, state, step=step)

    if n_steps % ckpt_every:  # else the loop's last save holds this very state
        checkpoint.save(ckpt_dir, state, step=n_steps)
    return state["params"], state["opt_state"], history
