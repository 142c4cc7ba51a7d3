"""Host-side training loop: checkpoint cadence, restart-resume, straggler
deadline, metric logging.

Counterpart of ``repro/train/loop.py``, with the same fault-tolerance
contract:
* every ``ckpt_every`` steps the full state is saved asynchronously (the
  host copy is taken before the next step), and a final save blocks;
* on (re)start the loop restores the latest published checkpoint onto
  ``device`` (and with ``shardings`` onto their mesh, whatever mesh saved
  it) and the data pipeline resumes at the same batch index, so a killed
  job continues exactly (up to the save cadence);
* a per-step wall-clock deadline flags stragglers.
The report also carries the final state, since the loop owns it.  On a
mesh every rank runs the loop; the step counter and the metrics, replicated
DTensors there, are gathered explicitly before the host reads them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.ckpt.checkpoint import CheckpointConfig, Checkpointer
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source
from repro_torch.utils import whole


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    ckpt: Optional[CheckpointConfig] = None
    log_every: int = 10
    step_deadline_s: Optional[float] = None   # straggler threshold
    max_straggler_strikes: int = 3


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    resumed_from: Optional[int]
    metrics_history: list
    straggler_strikes: int
    wall_s: float
    state: Optional[dict] = None              # the state after the last step


def run(loop_cfg: LoopConfig, data_cfg: DataConfig, train_step: Callable,
        init_state_fn: Callable, log_fn: Callable = print, *,
        device=None, shardings=None) -> LoopReport:
    """Run (or resume) training; returns the report.  ``train_step(state,
    batch) → (state, metrics)`` takes numpy batches; ``init_state_fn()``
    builds a fresh state when no checkpoint exists; a checkpoint is
    restored onto ``device``, which ``loop_cfg.ckpt`` requires, and placed
    by ``shardings`` (a ``sharding.to_named`` tree) where given.  A step's
    time ends when its loss reaches the host."""
    ckpt = None
    if loop_cfg.ckpt is not None:
        if device is None:
            raise ValueError("a loop with checkpoints needs the device to "
                             "restore onto")
        ckpt = Checkpointer(loop_cfg.ckpt)
    resumed_from = None
    if ckpt and ckpt.latest_step() is not None:
        state = ckpt.restore(device=device, shardings=shardings)
        resumed_from = int(whole(state["step"]))
    else:
        state = init_state_fn()
    start_step = int(whole(state["step"]))

    source = make_source(data_cfg)
    prefetch = Prefetcher(source, start_index=start_step)
    history = []
    strikes = 0
    t_loop = time.time()
    try:
        for step in range(start_step, loop_cfg.total_steps):
            batch = prefetch.next()
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(whole(metrics["loss"]))  # waits for the device
            dt = time.time() - t0

            if loop_cfg.step_deadline_s and dt > loop_cfg.step_deadline_s:
                strikes += 1
                log_fn(f"[straggler] step {step} took {dt:.3f}s "
                       f"(deadline {loop_cfg.step_deadline_s}s, "
                       f"strike {strikes}/{loop_cfg.max_straggler_strikes})")
                if strikes >= loop_cfg.max_straggler_strikes:
                    log_fn("[straggler] persistent — signal orchestrator to "
                           "evict/replace this host; continuing")
                    strikes = 0

            if step % loop_cfg.log_every == 0 or \
                    step == loop_cfg.total_steps - 1:
                m = {k: float(whole(v)) for k, v in metrics.items()}
                m["loss"] = loss
                m["step"] = step
                m["step_time_s"] = dt
                history.append(m)
                log_fn(f"step {step}: loss={m['loss']:.4f} "
                       f"acc={m.get('accuracy', 0):.3f} {dt*1e3:.0f}ms")

            if ckpt and (step + 1) % loop_cfg.ckpt_every == 0:
                ckpt.save(step + 1, state, blocking=False)
        if ckpt:
            ckpt.save(loop_cfg.total_steps, state, blocking=True)
    finally:
        prefetch.close()
        if ckpt:
            ckpt.wait()
    return LoopReport(
        steps_run=loop_cfg.total_steps - start_step,
        resumed_from=resumed_from,
        metrics_history=history,
        straggler_strikes=strikes,
        wall_s=time.time() - t_loop,
        state=state,
    )
