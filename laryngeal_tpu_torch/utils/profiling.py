"""Profiling utilities (counterpart of ``laryngeal_tpu/utils/profiling.py``).

- ``StepTimer``: wall-clock per-step statistics (mean / median / p95,
  steps/s, items/s) with the first ``warmup`` steps left out.
- ``block``: a completion barrier; on a CUDA tensor (or with none given
  while a card is present) it synchronises the card.
- ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA activities, writing a Chrome trace (``*.pt.trace.json``, which
  TensorBoard's profiler plugin and ``chrome://tracing`` load) into
  ``logdir`` when the region ends. The training CLI wraps the same region in
  it as the JAX CLI (``trainer.train()``, ``--profile_dir``). On a run with a
  card, a profiler that cannot start raises: a trace that is silently empty
  would read as one that saw no work.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def block(x: Optional[torch.Tensor] = None) -> None:
    """Wait for the work queued on the card: ``x``'s device, or the
    current one when ``x`` is None. No-op for a CPU tensor or without a
    card."""
    if x is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif x.is_cuda:
        torch.cuda.synchronize(x.device)


class StepTimer:
    def __init__(self, warmup: int = 1, items_per_step: int = 1):
        self.warmup = warmup
        self.items_per_step = items_per_step
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "median_s": float(np.median(t)),
            "p95_s": float(np.quantile(t, 0.95)),
            "steps_per_sec": float(1.0 / t.mean()),
            "items_per_sec": float(self.items_per_step / t.mean()),
        }


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, cuda: Optional[bool] = None):
    """Profile the region into ``logdir`` (module docstring); no-op when
    ``logdir`` is None. ``cuda`` (default: whether a card is present) adds
    the CUDA activities and makes a failure to start an error."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available() if cuda is None else cuda
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir)))
    try:
        prof.start()
    except Exception as e:
        if cuda:
            raise RuntimeError(f"torch.profiler did not start on the card: {e}") from e
        yield None
        return
    try:
        yield prof
    finally:
        prof.stop()
