"""Cross-replica out-of-range synchronization.

A JAX re-design of the reference's ``SyncReplicasDataset``
(``/root/reference/hybridbackend/tensorflow/data/sync/sync_replicas_dataset.cc:34-213``
+ ``hook.py:35-152``): every step, workers agree whether anyone (or
everyone) has exhausted their data partition so all replicas stop
*together* — otherwise collectives in the training step would deadlock.

The reference allreduces an exhaustion count through a session hook and
lets TF carry variable-shape final batches. XLA needs static shapes, so
the static-shape non-drop contract is **pad + per-row validity weights**:

* Every step the replicas exchange ``(has_data, rows)`` and agree on a
  global row count (the max across replicas).
* Every emitted batch is padded to that row count and carries a
  ``batch['_sync_valid']`` float32 ``[rows]`` column — 1.0 for real
  rows, 0.0 for padding and for batches synthesized by exhausted
  replicas.
* Metrics consume ``_sync_valid`` as example weights
  (``Trainer.evaluate``), which makes global eval metrics bit-exact
  under uneven final batches — the property the reference gets from
  variable shapes (``metrics/auc.py:169``).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from hybridbackend_tpu.data.dataframe import Batch, Value, num_rows
from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('data_sync_drop_remainder', True,
                 env='HB_DATA_SYNC_DROP_REMAINDER',
                 doc='Stop all replicas when ANY runs out (True) or only '
                     'when ALL run out (False).')
OPTIONS.register('data_sync_timeout_ms', 120_000,
                 env='HB_DATA_SYNC_TIMEOUT_MS',
                 doc='Max time to wait for a peer replica in the per-step '
                     'sync exchange before raising an error naming the '
                     'lagging rank.')

#: Per-row validity column attached to every batch in non-drop mode.
SYNC_VALID_KEY = '_sync_valid'

# One id per iterator, identical across processes as long as iterators
# are constructed in the same (SPMD) order — keys below must match.
_SYNC_IDS = itertools.count()


def _coord_client():
  """The jax.distributed coordination-service KV client (None when the
  distributed runtime is not initialized)."""
  try:
    from jax._src import distributed
    return distributed.global_state.client
  except Exception:  # noqa: BLE001 — internal API; fall back gracefully
    return None


class SyncCancelled(Exception):
  """The iterator was closed while its exchange was in flight."""


def _kv_exchange(client, sid: int, step: int, rank: int, world: int,
                 has_data: bool, rows: int,
                 cancel=None) -> Tuple[bool, bool, int]:
  """Exchange (has_data, rows) through the coordination KV store.

  This deliberately AVOIDS device collectives: the exchange runs on the
  prefetch producer thread while the consumer thread issues the
  train/eval step's collectives — two threads racing on the collective
  stream can order their ops differently across processes and deadlock.
  KV traffic rides the coordination service instead and cannot
  interleave with XLA collectives.

  The peer wait is sliced into short blocking gets so that (a) a closed
  iterator cancels promptly instead of stalling its producer thread, and
  (b) a dead or lagging peer raises a crisp error *naming the rank*
  rather than hanging for minutes (reference liveness contract:
  ``sync_replicas_dataset.cc:109-213`` fails fast through session
  errors).
  """
  import jax

  base = f'hb/sync/{sid}/{step}'
  client.key_value_set(f'{base}/{rank}', f'{int(has_data)},{int(rows)}')
  total_ms = int(OPTIONS['data_sync_timeout_ms'])
  slice_ms = min(2_000, total_ms)
  any_d, all_d, mx = False, True, 0
  import time
  for r in range(world):
    t0 = time.monotonic()
    while True:
      if cancel is not None and cancel.is_set():
        raise SyncCancelled()
      attempt_t0 = time.monotonic()
      try:
        raw = client.blocking_key_value_get(f'{base}/{r}', slice_ms)
        break
      except jax.errors.JaxRuntimeError as e:
        # Only a timed-out get means "keep waiting". Any other failure
        # (coordination service shut down, connection refused) would
        # otherwise busy-loop failing RPCs and then misreport the peer
        # as stalled — surface the real cause instead.
        msg = str(e)
        if not ('DEADLINE_EXCEEDED' in msg or 'deadline' in msg.lower()
                or 'timeout' in msg.lower() or 'timed out' in msg.lower()):
          raise RuntimeError(
              f'SyncReplicasIterator: coordination-service get for key '
              f'{base}/{r} failed (this is rank {rank}): {msg}') from e
        # Wall clock, not slice count: a get that errors out early must
        # not burn through the budget faster than real time.
        if (time.monotonic() - t0) * 1000 >= total_ms:
          raise RuntimeError(
              f'SyncReplicasIterator: replica {r} did not reach sync '
              f'step {step} within {total_ms} ms (this is rank {rank}; '
              f'key {base}/{r}). The peer is dead or stalled.') from None
        # A deadline-classified failure that returned near-instantly
        # must not hot-loop RPCs against the coordination service.
        if time.monotonic() - attempt_t0 < 0.1:
          time.sleep(0.1)
    h, n = raw.split(',')
    h = bool(int(h))
    any_d |= h
    all_d &= h
    mx = max(mx, int(n))
  if step >= 2:
    # Bound key growth: everyone has consumed step-2 by now.
    try:
      client.key_value_delete(f'hb/sync/{sid}/{step - 2}/{rank}')
    except Exception:  # noqa: BLE001 — GC is best-effort
      pass
  return any_d, all_d, mx


def _global_state(local_has_data: bool, local_rows: int,
                  ctx: Context, sid: int = 0,
                  step: int = 0, cancel=None) -> Tuple[bool, bool, int]:
  """Returns (any_has_data, all_have_data, global_max_rows)."""
  if ctx.num_processes <= 1:
    return local_has_data, local_has_data, local_rows
  client = _coord_client()
  if client is not None:
    import jax
    return _kv_exchange(client, sid, step, jax.process_index(),
                        ctx.num_processes, local_has_data, local_rows,
                        cancel=cancel)
  from jax.experimental import multihost_utils
  flags = multihost_utils.process_allgather(
      np.asarray([int(local_has_data), int(local_rows)], np.int32))
  flags = np.asarray(flags).reshape(-1, 2)
  return (bool(flags[:, 0].max()), bool(flags[:, 0].min()),
          int(flags[:, 1].max()))


def _pad_column(col, target: int):
  """Extend a column to ``target`` rows with empty/zero padding rows."""
  cur = num_rows(col)
  if cur == target:
    return col
  extra = target - cur
  if isinstance(col, Value):
    splits = list(col.row_splits)
    s0 = splits[0]
    splits[0] = np.concatenate(
        [s0, np.full((extra,), s0[-1], np.int64)])
    return Value(col.values, splits)
  arr = np.asarray(col)
  pad = np.zeros((extra,) + arr.shape[1:], arr.dtype)
  return np.concatenate([arr, pad])


class SyncReplicasIterator:
  """Wraps a per-host batch iterator with replica-synchronized stopping.

  In ``drop_remainder`` mode (train default) iteration stops as soon as
  any replica is exhausted; batches pass through untouched. Otherwise
  (eval) it continues until every replica is exhausted; every batch is
  padded to the step's global row count and carries a
  ``_sync_valid`` weight column (see module docstring) so globally-exact
  metrics ignore padding (reference semantics:
  ``sync_replicas_dataset.cc:109-213``).
  """

  def __init__(self, iterator: Iterator[Batch],
               drop_remainder: Optional[bool] = None,
               ctx: Optional[Context] = None):
    import threading
    self._it = iter(iterator)
    self._ctx = ctx or Context.get()
    if drop_remainder is None:
      drop_remainder = bool(OPTIONS['data_sync_drop_remainder'])
    self._drop_remainder = drop_remainder
    self._template: Optional[Batch] = None
    self._sid = next(_SYNC_IDS)
    self._step_no = 0
    self._cancel = threading.Event()

  def __iter__(self):
    return self

  def close(self) -> None:
    """Cancel any in-flight peer wait and GC this rank's KV keys.

    An abandoned iterator (consumer ``break``, early ``close``) must not
    leave its producer thread blocked in a peer wait, nor leak its
    coordination keys for the life of the job."""
    self._cancel.set()
    self._gc_keys()

  def _gc_keys(self) -> None:
    client = _coord_client()
    if client is None or self._ctx.num_processes <= 1:
      return
    import jax
    rank = jax.process_index()
    # The rolling delete in _kv_exchange leaves at most the final two
    # steps' keys; clear them (best-effort — the service tolerates
    # deletes of missing keys).
    for s in range(max(0, self._step_no - 2), self._step_no + 1):
      try:
        client.key_value_delete(f'hb/sync/{self._sid}/{s}/{rank}')
      except Exception:  # noqa: BLE001
        pass

  def _finalize(self) -> None:
    """Zero-leak teardown at synchronized exhaustion.

    All replicas reach this after completing the SAME final exchange, so
    a short barrier proves every peer finished its read loop — after
    which deleting this rank's remaining keys cannot race a reader."""
    client = _coord_client()
    if client is None or self._ctx.num_processes <= 1 or self._cancel.is_set():
      return
    try:
      # Peers completed the same exchange microseconds apart; a short
      # timeout only fires if some rank took an abnormal exit path, in
      # which case we just skip GC.
      client.wait_at_barrier(f'hb/sync/{self._sid}/done', 10_000)
    except Exception:  # noqa: BLE001 — GC barrier is best-effort
      return
    self._gc_keys()

  def _empty_like(self, template: Batch, target: int) -> Batch:
    """A ``target``-row batch of the template's schema with no valid
    rows: ragged columns get ``target`` empty rows, dense columns zero
    rows (consistent shapes across hosts for the global assembly)."""
    out: Batch = {}
    for k, v in template.items():
      if k == SYNC_VALID_KEY:
        continue
      if isinstance(v, Value):
        splits = [np.zeros(target + 1, np.int64)]
        splits += [np.zeros(1, np.int64) for _ in range(v.ragged_rank - 1)]
        out[k] = Value(
            np.zeros((0,) + v.values.shape[1:], v.values.dtype), splits)
      else:
        arr = np.asarray(v)
        dtype = np.bool_ if k.endswith('_mask') else arr.dtype
        out[k] = np.zeros((target,) + arr.shape[1:], dtype)
    out[SYNC_VALID_KEY] = np.zeros((target,), np.float32)
    return out

  def _padded(self, batch: Batch, target: int) -> Batch:
    rows = 0
    for col in batch.values():
      rows = num_rows(col)
      break
    out = {k: _pad_column(v, target) for k, v in batch.items()
           if k != SYNC_VALID_KEY}
    valid = np.zeros((target,), np.float32)
    valid[:rows] = 1.0
    out[SYNC_VALID_KEY] = valid
    return out

  def __next__(self) -> Batch:
    try:
      batch = next(self._it)
      has_data = True
    except StopIteration:
      batch = None
      has_data = False
    step = self._step_no
    self._step_no += 1
    if self._drop_remainder:
      try:
        any_data, all_data, _ = _global_state(has_data, 0, self._ctx,
                                              self._sid, step,
                                              cancel=self._cancel)
      except SyncCancelled:
        raise StopIteration from None
      if not all_data:
        self._finalize()
        raise StopIteration
      return batch  # type: ignore[return-value]
    rows = 0
    if batch is not None:
      for col in batch.values():
        rows = num_rows(col)
        break
    try:
      any_data, _, target = _global_state(has_data, rows, self._ctx,
                                          self._sid, step,
                                          cancel=self._cancel)
    except SyncCancelled:
      raise StopIteration from None
    if not any_data:
      self._finalize()
      raise StopIteration
    # The assembled global batch must divide the mesh's data axis:
    # round the agreed row count up to a multiple of the per-process
    # device count (padding rows carry zero weight anyway).
    lcl = max(1, self._ctx.world_size // self._ctx.num_processes)
    target = -(-target // lcl) * lcl
    if batch is None:
      if self._template is None:
        # Other replicas still have data but this one never produced a
        # batch, so there is no schema to synthesize padding from; an
        # empty worker partition cannot participate in the global
        # assembly (the reference requires non-empty partitions too).
        raise RuntimeError(
            'SyncReplicasIterator: replica exhausted before producing '
            'any batch while peers still have data; ensure every worker '
            'partition is non-empty.')
      return self._empty_like(self._template, target)
    self._template = batch
    return self._padded(batch, target)


__all__ = ['SyncReplicasIterator', 'SYNC_VALID_KEY']
