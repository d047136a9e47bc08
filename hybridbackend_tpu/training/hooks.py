"""Training hooks: step stats and timer-driven policies.

Parity with the reference's ``Policy``/``StepStatHook``
(``/root/reference/hybridbackend/tensorflow/training/hooks.py:36-321``):
``StepStatHook`` logs secs/step percentiles (p10/p50/p90) and
samples/sec; ``Policy`` invokes a callback every N steps or T seconds.
Hooks are plain objects driven by the Trainer loop — no session magic.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

LOG = logging.getLogger('hybridbackend_tpu')


class Hook:
  """Training-loop hook interface."""

  def begin(self) -> None:
    pass

  def before_step(self, step: int) -> None:
    pass

  def after_step(self, step: int, metrics: Dict[str, Any]) -> None:
    pass

  def end(self, step: int) -> None:
    pass


class StepStatHook(Hook):
  """Step-time/throughput percentiles (reference ``hooks.py:231-321``).

  JAX dispatch is asynchronous: the wall time around ``step()`` measures
  enqueue, not execution. The hook therefore forces a device sync every
  ``sync_every_n`` steps (on a scalar metric when present — cheap) and
  reports amortized per-step time over each synced window. Per-step
  percentiles are still recorded for dispatch-stall diagnosis.
  """

  def __init__(self, batch_size: Optional[int] = None,
               every_n_steps: int = 100, warmup_steps: int = 1,
               sync_every_n: int = 20,
               log: Callable[[str], None] = LOG.info):
    self._batch_size = batch_size
    self._every_n = every_n_steps
    self._warmup = warmup_steps
    self._sync_n = max(1, sync_every_n)
    self._log = log
    self._durations: list = []
    self._synced: list = []           # amortized secs/step per window
    self._count = 0
    self._prev: Optional[float] = None
    self._window_t0: Optional[float] = None
    self._window_n = 0
    self._input_it = None

  def set_input_iterator(self, it) -> None:
    """Attach the feeding ``DeviceIterator`` so reports can attribute
    slow steps to input starvation (queue-empty stalls) instead of
    compute — round-4 weak #3; reference diagnoses the same via
    step-time percentiles (``hooks.py:231-321``)."""
    self._input_it = it

  @property
  def durations(self) -> np.ndarray:
    return np.asarray(self._durations)

  @property
  def synced_secs_per_step(self) -> np.ndarray:
    return np.asarray(self._synced)

  def before_step(self, step: int) -> None:
    self._prev = time.perf_counter()
    if self._window_t0 is None:
      self._window_t0 = self._prev

  @staticmethod
  def _sync(metrics: Dict[str, Any]) -> None:
    for v in metrics.values():
      if hasattr(v, 'block_until_ready'):
        try:
          float(np.asarray(v).ravel()[0] if np.asarray(v).size else 0.0)
        except (TypeError, ValueError):
          v.block_until_ready()
        return

  def after_step(self, step: int, metrics: Dict[str, Any]) -> None:
    if self._prev is None:
      return
    dt = time.perf_counter() - self._prev  # before any sync stall
    self._count += 1
    if self._count <= self._warmup:
      # Warmup (compile) steps never enter a synced window.
      self._window_t0 = None
      self._window_n = 0
      return
    self._window_n += 1
    if self._window_n >= self._sync_n:
      self._sync(metrics)
      now = time.perf_counter()
      if self._window_t0 is not None:
        self._synced.append((now - self._window_t0) / self._window_n)
      self._window_t0 = None
      self._window_n = 0
    self._durations.append(dt)
    if self._every_n and len(self._durations) % self._every_n == 0:
      self._report()

  def _report(self) -> None:
    if not self._durations:
      return
    d = np.asarray(self._durations)
    p10, p50, p90 = np.percentile(d, [10, 50, 90])
    msg = (f'dispatch secs/step: p10={p10:.4f} p50={p50:.4f} '
           f'p90={p90:.4f}')
    if self._synced:
      s = float(np.median(self._synced))
      msg = f'secs/step (synced): {s:.4f}, ' + msg
      if self._batch_size:
        msg += f', samples/sec={self._batch_size / s:,.0f}'
    elif self._batch_size:
      msg += f', samples/sec p50={self._batch_size / p50:,.0f}'
    stats = getattr(self._input_it, 'stall_stats', None)
    if stats is not None:
      msg += (f", input stalls {stats['stalls']}/{stats['gets']} "
              f"({100.0 * stats['stall_fraction']:.1f}%, "
              f"{stats['stall_s']:.2f}s waited)")
    self._log(msg)

  def end(self, step: int) -> None:
    self._report()


class Policy(Hook):
  """Invoke ``callback(step, metrics)`` every N steps and/or T seconds
  (reference ``Policy``/``Policy.Trigger``, ``hooks.py:36-160``)."""

  def __init__(self, callback: Callable[[int, Dict[str, Any]], None],
               every_n_steps: Optional[int] = None,
               every_n_secs: Optional[float] = None):
    if every_n_steps is None and every_n_secs is None:
      raise ValueError('Policy needs every_n_steps and/or every_n_secs')
    self._cb = callback
    self._every_n = every_n_steps
    self._every_s = every_n_secs
    self._last_t = time.time()

  def after_step(self, step: int, metrics: Dict[str, Any]) -> None:
    fire = False
    if self._every_n and step > 0 and step % self._every_n == 0:
      fire = True
    if self._every_s and (time.time() - self._last_t) >= self._every_s:
      fire = True
    if fire:
      self._last_t = time.time()
      self._cb(step, metrics)


class LoggingHook(Policy):
  """Log loss/metrics every N steps."""

  def __init__(self, every_n_steps: int = 100,
               log: Callable[[str], None] = LOG.info):
    def _cb(step, metrics):
      parts = []
      for k, v in sorted(metrics.items()):
        try:
          parts.append(f'{k}={float(np.asarray(v).mean()):.5f}')
        except (TypeError, ValueError):
          continue
      log(f'step {step}: ' + ', '.join(parts))
    super().__init__(_cb, every_n_steps=every_n_steps)


class SummaryHook(Policy):
  """Write train scalars as TensorBoard summaries every N steps
  (reference ``Policy.Trigger``'s ``tf.summary`` writes,
  ``hooks.py:36-160``). Pass a
  :class:`hybridbackend_tpu.utils.summary.SummaryWriter` or a logdir
  string."""

  def __init__(self, writer, every_n_steps: int = 100,
               prefix: str = 'train/'):
    from hybridbackend_tpu.utils.summary import SummaryWriter
    if isinstance(writer, str):
      writer = SummaryWriter(writer)
    self.writer = writer

    def _cb(step, metrics):
      vals = {}
      for k, v in sorted(metrics.items()):
        try:
          vals[prefix + k] = float(np.asarray(v).mean())
        except (TypeError, ValueError):
          continue
      writer.scalars(step, vals)
    super().__init__(_cb, every_n_steps=every_n_steps)

  def end(self, step: int) -> None:
    self.writer.flush()


__all__ = ['Hook', 'StepStatHook', 'Policy', 'LoggingHook', 'SummaryHook']
