"""Fault-tolerant training runner (the reference's
``repro.runtime.fault_tolerance``): checkpoint and resume, failure
injection for tests, and straggler detection.

The runner's state is any tree :mod:`repro_torch.checkpoint` saves; the LM
launcher's is ``(model, opt_state)``, the parameters and the AdamW state
(the step counter and the moments), updated in place by the step.  A run
killed after a checkpoint and started again continues from it bit for bit.

A step's ``dt`` (host clock) includes reading its metrics back to the host,
so it ends when the step's work on the card has (the reference's ``dt``
stops before its read-back, at dispatch).
"""
from __future__ import annotations

import time

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint


class StragglerMonitor:
    """EWMA step-time monitor.

    A step slower than ``threshold`` times the EWMA is a straggler event;
    ``callback(step, dt, ewma)`` is where mitigation would hook in."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.5,
                 warmup: int = 3, callback=None):
        self.alpha, self.threshold, self.warmup = alpha, threshold, warmup
        self.callback = callback
        self.ewma = None
        self.n = 0
        self.events: list[tuple[int, float, float]] = []

    def record(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self.n > self.warmup
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.events.append((step, dt, self.ewma))
            if self.callback:
                self.callback(step, dt, self.ewma)
        else:
            # stragglers don't poison the mean
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class TrainRunner:
    """``step_fn(state, batch) -> (state, metrics)``; ``make_batch(step)``.

    ``run`` resumes from the latest checkpoint in ``ckpt_dir``, raises at
    ``fail_at_step`` (before that step runs), checkpoints every
    ``ckpt_every`` steps and at the end, and joins the pending write before
    it returns or raises."""

    def __init__(self, step_fn, make_batch, ckpt_dir, *,
                 ckpt_every: int = 50, async_ckpt: bool = True,
                 fail_at_step: int | None = None,
                 monitor: StragglerMonitor | None = None):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.async_ckpt = async_ckpt
        self.fail_at_step = fail_at_step
        self.monitor = monitor or StragglerMonitor()
        self._pending = None

    def resume_or_init(self, init_state):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return init_state, 0
        return load_checkpoint(self.ckpt_dir, step, init_state), step

    def _join(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def run(self, init_state, n_steps: int, start_step: int | None = None):
        state, step0 = self.resume_or_init(init_state)
        if start_step is not None:
            step0 = start_step
        hist = []
        try:
            for step in range(step0, n_steps):
                if self.fail_at_step is not None and step == self.fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, self.make_batch(step))
                row = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.monitor.record(step, dt)
                hist.append({**row, "step": step, "dt": dt})
                if (step + 1) % self.ckpt_every == 0 or step + 1 == n_steps:
                    self._join()
                    self._pending = save_checkpoint(
                        self.ckpt_dir, step + 1, state,
                        async_write=self.async_ckpt)
        finally:
            self._join()
        return state, hist
