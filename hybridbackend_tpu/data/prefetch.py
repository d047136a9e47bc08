"""Asynchronous host→device prefetching.

A JAX re-design of the reference's prefetch buffer + H2D transfer
ops (``/root/reference/hybridbackend/tensorflow/data/prefetch/prefetch.cc``
and ``ops/transfer/*``): the reference runs taker threads that fill a
C++ buffer resource and copies pinned host tensors to the GPU on a side
stream. In JAX, host→device DMA is issued by ``jax.device_put`` (which
is asynchronous), so the framework's job is pipelining: a background
thread converts host batches into (globally sharded) device arrays a few
steps ahead of consumption, overlapping Parquet decode + H2D with the
training step.

Multi-host assembly uses ``jax.make_array_from_process_local_data`` —
each host contributes its local shard of the global batch (reference:
per-host file partitions, ``dataset_v2.py:49-50``).
"""

from __future__ import annotations

import queue as _queue
import threading
import time as _time
from typing import Any, Callable, Dict, Iterator, Optional

import jax
import numpy as np

from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('data_prefetch_capacity', 2, env='HB_DATA_PREFETCH_CAPACITY',
                 doc='Device batches to stage ahead of the consumer.')


def _put_batch(batch: Dict[str, np.ndarray], ctx: Context,
               sharded: bool, shard_dim: int = 0) -> Dict[str, jax.Array]:
  out = {}
  for k, v in batch.items():
    v = np.asarray(v)
    if sharded and 0 < v.ndim <= shard_dim and ctx.num_processes > 1:
      # A multi-process 'replicated' array assembled from DIFFERING
      # per-host data would silently diverge across hosts — refuse
      # instead (the array lacks the declared batch axis).
      raise ValueError(
          f'batch column {k!r} has ndim {v.ndim} <= shard_dim '
          f'{shard_dim}: it carries no batch axis to shard, and '
          'replicating per-host data across processes is unsound. '
          'Reshape it to include the batch axis or drop it.')
    if sharded and v.ndim > shard_dim:
      if v.ndim == 1:
        sharding = ctx.batch_sharding
      else:
        spec = [None] * v.ndim
        spec[shard_dim] = ctx.data_axes
        sharding = ctx.sharding(*spec)
      if ctx.num_processes > 1:
        out[k] = jax.make_array_from_process_local_data(sharding, v)
      else:
        out[k] = jax.device_put(v, sharding)
    else:
      out[k] = jax.device_put(v, ctx.replicated_sharding)
  return out


class DeviceIterator:
  """Iterates device-resident batches with background prefetch.

  Mirrors the reference ``hb.data.Iterator`` semantics
  (``iterator.py:45-407``): bounded capacity, cancellation on close,
  exceptions from the producer re-raised at the consumer.
  """

  def __init__(self, host_iterator: Iterator[Dict[str, np.ndarray]],
               ctx: Optional[Context] = None,
               capacity: Optional[int] = None,
               sharded: bool = True,
               transform: Optional[Callable[[Dict[str, np.ndarray]],
                                            Dict[str, np.ndarray]]] = None,
               producer_put: Optional[bool] = None,
               shard_dim: int = 0):
    self._ctx = ctx or Context.get()
    self._capacity = capacity or int(OPTIONS['data_prefetch_capacity'])
    self._q: _queue.Queue = _queue.Queue(maxsize=self._capacity)
    self._stop = threading.Event()
    self._sharded = sharded
    self._shard_dim = shard_dim  # batch axis (1 for [G, B] multi-batch
                                 # groups, reference iterators.py:74-272)
    self._transform = transform
    self._inner = host_iterator
    if producer_put is None:
      # Multi-process: exactly ONE thread per process may touch the
      # runtime. A producer-thread device_put interleaving with the
      # consumer thread's collective launches can order runtime work
      # differently across processes and wedge the job (observed on the
      # CPU+Gloo backend; some PJRT clients serialize, but the
      # single-owner rule is the portable contract). device_put dispatch
      # is asynchronous, so consumer-side placement still overlaps the
      # actual H2D DMA with the previous step's execution.
      producer_put = self._ctx.num_processes <= 1
    self._producer_put = producer_put
    # Input-stall accounting (round-4 weak #3): a slow step must be
    # attributable to input starvation vs compute. A "stall" is a
    # __next__ that found the queue EMPTY and had to wait on the
    # producer; stall_s accumulates that wait. The reference surfaces
    # step-time percentiles for the same diagnosis (hooks.py:231-321).
    self.gets = 0
    self.stalls = 0
    self.stall_s = 0.0
    self._thread = threading.Thread(
        target=self._producer, args=(iter(host_iterator),), daemon=True)
    self._thread.start()

  @property
  def stall_stats(self) -> Dict[str, float]:
    """``{'gets', 'stalls', 'stall_s', 'stall_fraction'}`` so far."""
    return {'gets': self.gets, 'stalls': self.stalls,
            'stall_s': self.stall_s,
            'stall_fraction': self.stalls / max(self.gets, 1)}

  def _producer(self, it):
    try:
      for batch in it:
        if self._transform is not None:
          batch = self._transform(batch)
        if self._producer_put:
          batch = _put_batch(batch, self._ctx, self._sharded,
                             self._shard_dim)
        while not self._stop.is_set():
          try:
            self._q.put(batch, timeout=0.1)
            break
          except _queue.Full:
            continue
        if self._stop.is_set():
          return
    except BaseException as e:
      self._q.put(e)
      return
    self._q.put(None)

  def __iter__(self):
    return self

  def __next__(self) -> Dict[str, jax.Array]:
    if self._stop.is_set():
      raise StopIteration
    self.gets += 1
    stalled = False
    waited = 0.0
    try:
      item = self._q.get_nowait()
    except _queue.Empty:
      stalled = True
      t0 = _time.perf_counter()
      item = self._q.get()
      waited = _time.perf_counter() - t0
      self.stalls += 1
      self.stall_s += waited
    if item is None or isinstance(item, BaseException):
      # End-of-stream sentinel or a producer crash: waiting for either
      # is not an input stall of a step — roll the accounting back so
      # post-mortem stall reports aren't skewed by the shutdown wait.
      self.gets -= 1
      if stalled:
        self.stalls -= 1
        self.stall_s -= waited
      if item is None:
        raise StopIteration
      raise item
    if not self._producer_put:
      item = _put_batch(item, self._ctx, self._sharded,
                        self._shard_dim)
    return item

  def close(self, join: bool = True) -> None:
    """Cancel the producer (reference: HbCancelPrefetch)."""
    self._stop.set()
    # Unblock a producer waiting inside the wrapped iterator (e.g. a
    # SyncReplicas peer wait) so the thread exits promptly.
    inner_close = getattr(self._inner, 'close', None)
    if callable(inner_close):
      try:
        inner_close()
      except Exception:  # noqa: BLE001 — teardown is best-effort
        pass
    try:
      while True:
        self._q.get_nowait()
    except _queue.Empty:
      pass
    # JOIN the producer (bounded): a daemon thread still inside a
    # coordination-service RPC at interpreter exit dies under the C++
    # client's teardown — observed as `terminate called ... FATAL:
    # exception not rethrown` + SIGABRT in a launcher child that had
    # finished its work (early-stop training leaves a live producer).
    # The cancel event bounds the RPC to one <= 2 s slice.
    if join and self._thread.is_alive():
      self._thread.join(timeout=10.0)

  def __del__(self):
    # Abandoned iterators (early break, islice) must not leave a
    # spinning producer pinning device batches. No join here: a GC
    # finalizer must not stall the collecting thread behind a producer
    # blocked in an uncancellable inner iterator.
    try:
      self.close(join=False)
    except Exception:
      pass


__all__ = ['DeviceIterator']
