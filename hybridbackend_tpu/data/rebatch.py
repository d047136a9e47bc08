"""Rebatching: resize reader micro-batches into exact training batches.

A JAX re-design of the reference's C++ ``RebatchBuffer``
(``/root/reference/hybridbackend/tensorflow/data/rebatch/rebatch_buffer.cc``
683 LoC + ``rebatch_dataset_v2.cc:46-410``): readers emit row-group-sized
micro-batches; the rebatcher buffers row slices (dense and ragged) and
emits exactly ``batch_size`` rows per output batch, optionally shuffling
within a bounded window. All row ops are vectorized NumPy over Arrow
buffer views, so the hot loop stays in C.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from hybridbackend_tpu.data.dataframe import (
    Batch, Value, concat_columns, num_rows, slice_rows, take_rows)


class RebatchBuffer:
  """Accumulates row slices and takes exact-size batches.

  Reference: ``RebatchBuffer`` (``buffer.h:31-117``) with dense & sparse
  take paths and shuffle support.
  """

  def __init__(self, shuffle: bool = False, seed: int = 0):
    self._chunks: List[Batch] = []
    self._rows = 0
    self._shuffle = shuffle
    self._rng = np.random.RandomState(seed)
    # Dense shuffle fast path: an in-place row reservoir — each take
    # samples n rows and backfills the holes from the tail, O(batch)
    # row copies per take instead of rebuilding the whole window.
    self._res: Optional[dict] = None
    self._res_n = 0

  @property
  def rows(self) -> int:
    return self._rows

  def put(self, batch: Batch) -> None:
    n = None
    for col in batch.values():
      c = num_rows(col)
      if n is None:
        n = c
      elif c != n:
        raise ValueError(f'Ragged batch: column sizes differ ({c} vs {n})')
    if not n:
      return
    self._rows += n
    if self._shuffle:
      all_dense = all(not isinstance(v, Value) for v in batch.values())
      if all_dense and not self._chunks:
        self._put_reservoir(batch, n)
        return
      if self._res is not None:
        # A ragged batch arrived: demote the reservoir to a chunk and
        # continue on the (row-exact, O(window)) rebuild path.
        self._chunks.append({k: a[:self._res_n]
                             for k, a in self._res.items()})
        self._res = None
        self._res_n = 0
    self._chunks.append(batch)

  def _put_reservoir(self, batch: Batch, n: int) -> None:
    if self._res is None:
      self._res = {}
      cap = max(4 * n, 1024)
      for k, v in batch.items():
        a = np.asarray(v)
        self._res[k] = np.empty((cap,) + a.shape[1:], a.dtype)
      self._res_n = 0
    for k, v in batch.items():
      a = np.asarray(v)
      r = self._res[k]
      if a.dtype != r.dtype or a.shape[1:] != r.shape[1:]:
        # Schema drift across micro-batches: demote to the chunk path,
        # whose concat promotes dtypes instead of silently casting.
        self._chunks.append({c: arr[:self._res_n]
                             for c, arr in self._res.items()})
        self._res = None
        self._res_n = 0
        self._chunks.append(batch)
        return
    first = next(iter(self._res.values()))
    if self._res_n + n > first.shape[0]:
      cap = max(2 * first.shape[0], self._res_n + n)
      for k, a in self._res.items():
        grown = np.empty((cap,) + a.shape[1:], a.dtype)
        grown[:self._res_n] = a[:self._res_n]
        self._res[k] = grown
    for k, v in batch.items():
      self._res[k][self._res_n:self._res_n + n] = np.asarray(v)
    self._res_n += n

  def take(self, n: int) -> Batch:
    """Remove and return exactly ``n`` rows (caller checks ``rows``).

    With ``shuffle``, the ``n`` rows are sampled uniformly (without
    replacement) from the ENTIRE buffered window — true reservoir-style
    shuffling like the reference's shuffle buffer, not merely a
    permutation within the emitted batch.
    """
    if n > self._rows:
      raise ValueError(f'take({n}) > buffered rows {self._rows}')
    if self._shuffle:
      if self._res is not None and not self._chunks:
        return self._take_from_reservoir(n)
      return self._take_sampled(n)
    taken: List[Batch] = []
    got = 0
    while got < n:
      chunk = self._chunks[0]
      size = num_rows(next(iter(chunk.values())))
      need = n - got
      if size <= need:
        taken.append(chunk)
        self._chunks.pop(0)
        got += size
      else:
        taken.append({k: slice_rows(v, 0, need) for k, v in chunk.items()})
        self._chunks[0] = {k: slice_rows(v, need, size)
                           for k, v in chunk.items()}
        got += need
    self._rows -= n
    if len(taken) == 1:
      out = taken[0]
    else:
      keys = taken[0].keys()
      out = {k: concat_columns([t[k] for t in taken]) for k in keys}
    return out

  def _take_from_reservoir(self, n: int) -> Batch:
    """Uniform sample of ``n`` rows from the whole window; the holes
    are backfilled with (unselected) tail rows — O(n) row copies."""
    r = self._res_n
    sel = self._rng.permutation(r)[:n]
    out = {k: a[sel] for k, a in self._res.items()}
    sel_mask = np.zeros(r, np.bool_)
    sel_mask[sel] = True
    tail = np.arange(r - n, r)
    tail_keep = tail[~sel_mask[tail]]
    holes = sel[sel < r - n]
    for a in self._res.values():
      a[holes] = a[tail_keep]
    self._res_n -= n
    self._rows -= n
    return out

  def _take_sampled(self, n: int) -> Batch:
    if self._res is not None:
      # Mixed dense/ragged stream: fold the reservoir into the chunks.
      self._chunks.insert(0, {k: a[:self._res_n]
                              for k, a in self._res.items()})
      self._res = None
      self._res_n = 0
    if len(self._chunks) > 1:
      keys = self._chunks[0].keys()
      self._chunks = [{k: concat_columns([c[k] for c in self._chunks])
                       for k in keys}]
    chunk = self._chunks[0]
    perm = self._rng.permutation(self._rows)
    sel = perm[:n]
    rest = np.sort(perm[n:])           # remaining rows keep stream order
    out = {k: take_rows(v, sel) for k, v in chunk.items()}
    if len(rest):
      self._chunks = [{k: take_rows(v, rest) for k, v in chunk.items()}]
    else:
      self._chunks = []
    self._rows -= n
    return out


def rebatch(micro_batches: Iterator[Batch], batch_size: int,
            drop_remainder: bool = False, shuffle: bool = False,
            shuffle_buffer: Optional[int] = None,
            seed: int = 0) -> Iterator[Batch]:
  """Stream micro-batches through a :class:`RebatchBuffer`.

  With ``shuffle``, batches are taken only once ``shuffle_buffer`` rows
  are buffered (reference ``shuffle_batch``, ``table.py:194-275``), and
  each take permutes its rows; the window gives approximate global
  shuffling at bounded memory.
  """
  buf = RebatchBuffer(shuffle=shuffle, seed=seed)
  watermark = max(batch_size, shuffle_buffer or 0) if shuffle else batch_size
  for mb in micro_batches:
    buf.put(mb)
    while buf.rows >= watermark:
      yield buf.take(batch_size)
  while buf.rows >= batch_size:
    yield buf.take(batch_size)
  if buf.rows and not drop_remainder:
    yield buf.take(buf.rows)


__all__ = ['RebatchBuffer', 'rebatch']
