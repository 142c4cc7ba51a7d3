"""Host-side training loop: straggler deadline and metric logging.

Counterpart of ``repro/train/loop.py``.  Checkpointing and restart-resume
are not ported yet: a ``LoopConfig`` with ``ckpt`` set raises
``NotImplementedError`` until the checkpoint slice lands.  The report also
carries the final state, since the loop owns it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.data.pipeline import DataConfig, Prefetcher, make_source


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    ckpt: Optional[Any] = None                # not ported yet
    log_every: int = 10
    step_deadline_s: Optional[float] = None   # straggler threshold
    max_straggler_strikes: int = 3


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    metrics_history: list
    straggler_strikes: int
    wall_s: float
    state: Optional[dict] = None              # the state after the last step


def run(loop_cfg: LoopConfig, data_cfg: DataConfig, train_step: Callable,
        init_state_fn: Callable, log_fn: Callable = print) -> LoopReport:
    """Run training; returns the report.  ``train_step(state, batch) →
    (state, metrics)`` takes numpy batches; ``init_state_fn()`` builds the
    initial state.  A step's time ends when its loss reaches the host."""
    if loop_cfg.ckpt is not None:
        raise NotImplementedError(
            "checkpointing is not ported to repro_torch yet (ROADMAP §1 "
            "'Modules to port' item 9)")
    state = init_state_fn()
    start_step = int(state["step"])

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
            loss = float(metrics["loss"])        # waits for the device
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
                m = {k: float(v) for k, v in metrics.items()}
                m["loss"] = loss
                m["step"] = step
                m["step_time_s"] = dt
                history.append(m)
                log_fn(f"step {step}: loss={m['loss']:.4f} "
                       f"acc={m.get('accuracy', 0):.3f} {dt*1e3:.0f}ms")
    finally:
        prefetch.close()
    return LoopReport(
        steps_run=loop_cfg.total_steps - start_step,
        metrics_history=history,
        straggler_strikes=strikes,
        wall_s=time.time() - t_loop,
        state=state,
    )
