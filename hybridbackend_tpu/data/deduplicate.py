"""Deduplicated column storage and restoration.

Parity with the reference's dedup transform
(``/root/reference/hybridbackend/tensorflow/data/deduplicate/dataset.py:29-67``
and restore logic ``dataframe.py:300-396``): datasets may store a
repeated column once per distinct entity plus an index column
(``restore_idx``); after loading, value columns are re-expanded by
gathering with the index.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from hybridbackend_tpu.data.dataframe import Batch, Value, take_rows


def restore_deduplicated(batch: Batch, value_columns: Sequence[str],
                         index_column: str,
                         keep_index: bool = False) -> Batch:
  """Expand deduplicated ``value_columns`` using ``index_column``.

  ``batch[index_column]`` holds, for each output row, the row index into
  the deduplicated value columns. Returns a batch where every value
  column has the same row count as the index column.
  """
  if index_column not in batch:
    raise KeyError(f'Index column {index_column!r} not in batch')
  idx = np.asarray(batch[index_column]).astype(np.int64).reshape(-1)
  out: Batch = {}
  for name, col in batch.items():
    if name == index_column and not keep_index:
      continue
    if name in value_columns:
      out[name] = take_rows(col, idx)
    else:
      out[name] = col
  return out


def deduplicate(batch: Batch, value_columns: Sequence[str],
                key_column: str,
                index_column: str = 'restore_idx') -> Batch:
  """Inverse helper (storage-side): collapse rows with equal keys.

  Rows sharing ``batch[key_column]`` store their value columns once; an
  ``index_column`` is added for :func:`restore_deduplicated`.
  """
  keys = np.asarray(batch[key_column])
  uniq, first_pos, inverse = np.unique(keys, return_index=True,
                                       return_inverse=True)
  del uniq
  out: Batch = {}
  for name, col in batch.items():
    if name in value_columns:
      out[name] = take_rows(col, first_pos)
    else:
      out[name] = col
  out[index_column] = inverse.astype(np.int64)
  return out


__all__ = ['restore_deduplicated', 'deduplicate']
