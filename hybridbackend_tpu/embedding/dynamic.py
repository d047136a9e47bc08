"""Dynamic (hash-table) embeddings: DeepRec EmbeddingVariable parity.

A JAX re-design of the reference's DeepRec EV backend
(``/root/reference/hybridbackend/tensorflow/embedding/deeprecev.py:29-65``):
DeepRec's ``get_embedding_variable`` is a growing hash table keyed by
raw (unhashed, unbounded) feature ids; the reference row-shards it like
a dense table but skips the ``ids // num_shards`` index division
(``isdynamic=True``).

Under XLA the device table must be static-shaped, so the dynamic part —
the id→row hash map — lives on the host (the input pipeline touches
every id there anyway; this is also where DeepRec keeps its hash map,
just on the trainer CPU). Rows are assigned on first touch, with an
optional admission filter (DeepRec's counter-based feature filter:
an id must be seen ``min_count`` times before it gets a row; cold ids
read as zeros and take no gradient).

The device table is an ordinary (shardable) parameter of static
capacity; ``map_ids`` is called on host batches (e.g. as a
``DeviceIterator`` transform) to translate raw ids into table rows.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np

from hybridbackend_tpu.embedding.table import TableConfig


class IdMapper:
  """Host-side growing map from raw int64 ids to dense table rows.

  The id→row resolution is the reference's device slab-hash probe
  (``lookup_functors.cu.cc:40-170``) relocated to the host input
  path: it runs in the native open-addressing map
  (:class:`hybridbackend_tpu.native.NativeIdMap`, C++ over the C ABI,
  thread-parallel read probes — ~10 ns/id insert, ~1 ns/id bulk probe)
  with a vectorized NumPy+dict fallback that touches each *unique* id
  once rather than looping per occurrence.
  """

  def __init__(self, capacity: int, min_count: int = 1):
    from hybridbackend_tpu import native
    self.capacity = int(capacity)
    self.min_count = int(min_count)
    self._native = native.native_idmap(min(self.capacity, 1 << 20))
    self._map: Dict[int, int] = {}      # fallback mode only
    self._counts: Counter = Counter()   # fallback mode only
    self._next = 0

  @property
  def size(self) -> int:
    return self._next

  def map_ids(self, ids: np.ndarray, train: bool = True) -> np.ndarray:
    """Translate raw ids → rows; unadmitted/unknown ids map to -1
    (looked up as zeros by every lookup strategy's out-of-range
    contract)."""
    ids = np.asarray(ids)
    if self._native is not None:
      if train:
        rows, self._next = self._native.train_lookup(
            ids.reshape(-1), self.capacity, self._next,
            min_count=self.min_count)
      else:
        rows = self._native.lookup(ids.reshape(-1))
      return rows.astype(np.int64).reshape(ids.shape)
    return self._map_ids_numpy(ids, train)

  def _map_ids_numpy(self, ids: np.ndarray, train: bool) -> np.ndarray:
    """Fallback with NATIVE-IDENTICAL semantics: rows are assigned in
    first-touch occurrence order (not sorted-id order) and, with
    ``min_count``, only the admitting occurrence and later ones in the
    batch receive the row — so runs are reproducible whether or not the
    native lib is present. Dict cost ∝ unique ids, not occurrences."""
    shape = np.asarray(ids).shape
    flat = np.asarray(ids).reshape(-1)
    n = flat.size
    uniq, inverse = np.unique(flat, return_inverse=True)
    counts = np.bincount(inverse, minlength=len(uniq))
    order = np.argsort(inverse, kind='stable')
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    known = np.asarray([self._map.get(int(u), -1) for u in uniq],
                       np.int64)
    out = known[inverse]
    if not train:
      return out.reshape(shape)
    # Candidate admissions, ordered by their admitting position in the
    # batch (= native per-occurrence processing order).
    events = []
    for j in np.nonzero(known < 0)[0]:
      u = int(uniq[j])
      occ = int(counts[j])
      if self.min_count > 1:
        prior = self._counts[u]
        need = self.min_count - prior
        if occ < need:
          self._counts[u] += occ
          continue
        adm_rank = need - 1
      else:
        adm_rank = 0
      events.append((int(order[starts[j] + adm_rank]), j, adm_rank))
    for _, j, adm_rank in sorted(events):
      u = int(uniq[j])
      if self._next >= self.capacity:
        # Full: stays cold; pending count parks just below the
        # threshold so the next sighting retries admission (native
        # behavior).
        if self.min_count > 1:
          self._counts[u] = self.min_count - 1
        continue
      row = self._next
      self._next += 1
      self._map[u] = row
      if self.min_count > 1:
        self._counts.pop(u, None)
      grp = order[starts[j]:starts[j] + counts[j]]
      out[grp[adm_rank:]] = row   # admitting occurrence onward
      out[grp[:adm_rank]] = -1    # earlier occurrences stay cold
    return out.reshape(shape)

  def state_dict(self) -> Dict[str, np.ndarray]:
    """Serializable mapping state (checkpoint alongside the table).

    Includes pending ``min_count`` admission counters (ids partway to
    admission), so a resumed run admits ids at the same sighting as an
    uninterrupted one (DeepRec's counter filter state persists with the
    EV)."""
    if self._native is not None:
      ids_a, vals_a = self._native.items_all()
      adm = vals_a >= 0
      ids_adm, rows_adm = ids_a[adm], vals_a[adm]
      ids_pen = ids_a[~adm]
      counts_pen = (-1 - vals_a[~adm]).astype(np.int64)
      order = np.argsort(ids_adm)
      po = np.argsort(ids_pen)
      return {'ids': ids_adm[order].astype(np.int64),
              'rows': rows_adm[order].astype(np.int64),
              'pending_ids': ids_pen[po].astype(np.int64),
              'pending_counts': counts_pen[po],
              'next': np.asarray([self._next], np.int64)}
    items = np.asarray(sorted(self._map.items()), np.int64).reshape(-1, 2)
    pend = np.asarray(sorted(self._counts.items()), np.int64).reshape(-1, 2)
    return {'ids': items[:, 0], 'rows': items[:, 1],
            'pending_ids': pend[:, 0], 'pending_counts': pend[:, 1],
            'next': np.asarray([self._next], np.int64)}

  @classmethod
  def from_state_dict(cls, capacity: int, state: Dict[str, np.ndarray],
                      min_count: int = 1) -> 'IdMapper':
    m = cls(capacity, min_count)
    pend_ids = np.asarray(state.get('pending_ids', ()), np.int64)
    pend_counts = np.asarray(state.get('pending_counts', ()), np.int64)
    if m._native is not None:
      m._native.set(np.asarray(state['ids'], np.int64),
                    np.asarray(state['rows'], np.int32))
      if pend_ids.size:
        # Native encoding: pending count c -> raw val -1-c.
        m._native.set(pend_ids, (-1 - pend_counts).astype(np.int32))
    else:
      m._map = {int(i): int(r)
                for i, r in zip(state['ids'], state['rows'])}
      m._counts.update({int(i): int(c)
                        for i, c in zip(pend_ids, pend_counts)})
    m._next = int(state['next'][0])
    return m


class DynamicEmbedding:
  """A static-capacity table + host IdMapper = dynamic-vocab embedding.

  Usage::

      dyn = DynamicEmbedding('user_id', capacity=1_000_000, dim=32)
      table = create_table(dyn.config, rng)        # ordinary sharded param
      batch['user_id'] = dyn.mapper.map_ids(batch['user_id'])  # on host
      emb = lookup(table, batch['user_id'], dyn.config)
  """

  def __init__(self, name: str, capacity: int, dim: int,
               min_count: int = 1, **config_kwargs):
    self.config = TableConfig(name, capacity, dim, **config_kwargs)
    self.mapper = IdMapper(capacity, min_count=min_count)

  def transform(self, column: str):
    """A ``DeviceIterator(transform=...)`` mapping the raw-id column."""
    def _apply(batch):
      batch = dict(batch)
      batch[column] = self.mapper.map_ids(batch[column])
      return batch
    return _apply


__all__ = ['IdMapper', 'DynamicEmbedding']
