"""Columnar Parquet/ORC ingest for accelerator hosts.

A JAX re-design of the reference's tabular dataset
(``/root/reference/hybridbackend/tensorflow/data/tabular/``): the
reference implements a C++ TF dataset op over Arrow with zero-copy
string buffers (``dataset.cc:40-303``, ``parquet.cc``, ``orc.cc``). Here
the input pipeline runs on the host CPU next to Python, and Arrow's own
C++ readers (via pyarrow, which releases the GIL) fill the same role;
what this module adds is the framework semantics:

* schema inference from file footers (reference
  ``parquet_file_get_fields``, ``common/pybind11.cc:131-140``),
* file/row-group partitioning across hosts (reference
  ``partition_count/partition_index``, ``dataset_v2.py:49-50``),
* streamed micro-batch reads (row-group granularity) feeding the
  rebatcher,
* multi-threaded parallel reads (reference AUTOTUNE thread budgeting,
  ``table.py:94-117``).
"""

from __future__ import annotations

import concurrent.futures
import glob as _glob
import queue as _queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from hybridbackend_tpu.data.dataframe import (
    Batch, Field, Value, from_arrow)
from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('data_num_parallel_reads', 0,
                 env='HB_DATA_NUM_PARALLEL_READS',
                 doc='Reader threads per host (0 = auto).')


def _expand_files(filenames: Union[str, Sequence[str]]) -> List[str]:
  if isinstance(filenames, str):
    filenames = [filenames]
  out: List[str] = []
  for f in filenames:
    if any(c in f for c in '*?['):
      out.extend(sorted(_glob.glob(f)))
    else:
      out.append(f)
  if not out:
    raise ValueError(f'No files matched: {filenames}')
  return out


def _arrow_field_to_field(af) -> Field:
  import pyarrow as pa
  t = af.type
  rank = 0
  while pa.types.is_list(t) or pa.types.is_large_list(t):
    rank += 1
    t = t.value_type
  if pa.types.is_string(t) or pa.types.is_large_string(t):
    dtype = np.dtype(object)
  else:
    dtype = np.dtype(t.to_pandas_dtype())
  return Field(af.name, dtype=dtype, ragged_rank=rank)


def infer_fields(filename: str, format: str = 'parquet') -> List[Field]:
  """Read the schema from a file footer (no data IO)."""
  if format == 'parquet':
    import pyarrow.parquet as pq
    schema = pq.read_schema(filename)
  elif format == 'orc':
    import pyarrow.orc as po
    schema = po.ORCFile(filename).schema
  else:
    raise ValueError(f'Unknown format: {format}')
  return [_arrow_field_to_field(f) for f in schema]


class ParquetDataset:
  """Streams batches from Parquet (or ORC) files.

  Python-level parity with ``hb.data.ParquetDataset``
  (``tabular/dataset_v2.py:44-230``): iterating yields dict batches
  ``{name: ndarray | Value}`` of exactly ``batch_size`` rows (except a
  final partial batch unless ``drop_remainder``).

  Args:
    filenames: file paths or glob patterns.
    fields: columns to read; None = infer all from the first file.
    batch_size: rows per emitted batch.
    drop_remainder: drop the final short batch.
    partition_index/partition_count: this host reads files (and, within a
      single shared file, row groups) ``i ≡ partition_index (mod
      partition_count)``.
    shuffle: shuffle rows within a window of ``shuffle_buffer`` rows.
    num_parallel_reads: reader threads (0 = auto: min(files, cpu//2)).
    format: 'parquet' or 'orc'.
  """

  def __init__(self,
               filenames: Union[str, Sequence[str]],
               fields: Optional[Sequence[Union[Field, str]]] = None,
               batch_size: int = 1024,
               drop_remainder: bool = False,
               partition_index: int = 0,
               partition_count: int = 1,
               shuffle: bool = False,
               shuffle_buffer: Optional[int] = None,
               seed: int = 0,
               num_parallel_reads: Optional[int] = None,
               format: str = 'parquet',
               restore_columns: Sequence[str] = (),
               restore_index: str = 'restore_idx'):
    self._files = _expand_files(filenames)
    self._format = format
    inferred = {f.name: f for f in infer_fields(self._files[0], format)}
    if fields is None:
      self._fields = list(inferred.values())
    else:
      self._fields = []
      for f in fields:
        if isinstance(f, str):
          if f not in inferred:
            raise ValueError(f'Unknown column {f!r}; file has '
                             f'{sorted(inferred)}')
          self._fields.append(inferred[f])
        else:
          if f.name in inferred:
            got = inferred[f.name]
            if got.ragged_rank != f.ragged_rank:
              raise ValueError(
                  f'Field {f.name!r}: declared ragged_rank '
                  f'{f.ragged_rank} but file has {got.ragged_rank}')
          self._fields.append(f)
    self._batch_size = int(batch_size)
    self._drop_remainder = drop_remainder
    self._partition_index = partition_index
    self._partition_count = partition_count
    self._shuffle = shuffle
    self._shuffle_buffer = shuffle_buffer or (4 * self._batch_size)
    self._seed = seed
    if num_parallel_reads is None:
      num_parallel_reads = int(OPTIONS['data_num_parallel_reads'])
    self._threads = num_parallel_reads
    self._tls = threading.local()
    # In-pipeline dedup restoration (reference: deduplicate applied as
    # a dataset stage inside .batch(), tabular/table.py:218-223): files
    # stored with per-row-group deduplicated value columns + an index
    # column are re-expanded per micro-batch BEFORE rebatch, so every
    # emitted batch has uniform row counts.
    self._restore = (list(restore_columns), restore_index) \
        if restore_columns else None

  @property
  def fields(self) -> List[Field]:
    return list(self._fields)

  @property
  def batch_size(self) -> int:
    return self._batch_size

  # -- reading -------------------------------------------------------------

  def _my_files(self) -> List[str]:
    if self._partition_count <= 1:
      return self._files
    if len(self._files) >= self._partition_count:
      return self._files[self._partition_index::self._partition_count]
    return self._files  # fall through to row-group partitioning

  def _task_indices(self):
    """Enumerate (file_index, chunk_index) read units: one per Parquet
    row group / ORC stripe, honoring the host partition."""
    partition_groups = (self._partition_count > 1
                        and len(self._files) < self._partition_count)
    if self._partition_count <= 1 or partition_groups:
      my = list(enumerate(self._files))
    else:
      my = list(enumerate(self._files))[
          self._partition_index::self._partition_count]
    for fidx, fname in my:
      if self._format == 'orc':
        import pyarrow.orc as po
        n_chunks = po.ORCFile(fname).nstripes
      else:
        import pyarrow.parquet as pq
        n_chunks = pq.ParquetFile(fname).num_row_groups
      for c in range(n_chunks):
        if partition_groups and (
            c % self._partition_count != self._partition_index):
          continue
        yield fidx, c

  def _tasks(self):
    names = [f.name for f in self._fields]
    for fidx, c in self._task_indices():
      yield self._files[fidx], c, names

  def _read_chunk(self, fname: str, chunk: int, names: List[str]) -> Batch:
    """Read one row group / stripe (pyarrow releases the GIL; the actual
    decode is Arrow C++, the reference's reader core)."""
    reader = self._open_file(fname)
    if self._format == 'orc':
      tbl = reader.read_stripe(chunk, columns=names)
    else:
      tbl = reader.read_row_group(chunk, columns=names,
                                  use_threads=False)
    return {n: from_arrow(tbl.column(n)) for n in names}

  def _open_file(self, fname: str):
    # One reader handle per (thread, file): ParquetFile is not
    # documented thread-safe for concurrent reads.
    local = self._tls
    cache = getattr(local, 'readers', None)
    if cache is None:
      cache = local.readers = {}
    r = cache.get(fname)
    if r is None:
      if self._format == 'orc':
        import pyarrow.orc as po
        r = po.ORCFile(fname)
      else:
        import pyarrow.parquet as pq
        r = pq.ParquetFile(fname)
      cache[fname] = r
    return r

  def _iter_micro_batches(self) -> Iterator[Batch]:
    """Yield micro-batches (one per row group / stripe), deterministic
    order, decoded by a thread pool (reference: AUTOTUNE thread
    budgeting + parallel interleave, ``table.py:94-178``)."""
    threads = self._threads
    if threads == 0:
      import os as _os
      threads = max(1, min((_os.cpu_count() or 2), 16))
    if threads <= 1:
      for fname, chunk, names in self._tasks():
        yield self._read_chunk(fname, chunk, names)
      return
    # Ordered pipelined decode: keep up to 2*threads reads in flight,
    # emit strictly in task order (determinism + parallelism).
    import collections
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
      window: collections.deque = collections.deque()
      tasks = self._tasks()
      try:
        for _ in range(2 * threads):
          t = next(tasks, None)
          if t is None:
            break
          window.append(pool.submit(self._read_chunk, *t))
        while window:
          yield window.popleft().result()
          t = next(tasks, None)
          if t is not None:
            window.append(pool.submit(self._read_chunk, *t))
      finally:
        for f in window:
          f.cancel()

  def _native_iter(self) -> Optional[Iterator[Batch]]:
    """C++ data plane (decode → rebatch → prefetch in native threads);
    None when the columns or environment require the Python path."""
    from hybridbackend_tpu.native import tabular as native_tabular
    if not (native_tabular.available()
            and native_tabular.supports(self._fields)):
      return None
    try:
      import pyarrow as pa

      def read_schema(fname):
        if self._format == 'orc':
          import pyarrow.orc as po
          return po.ORCFile(fname).schema
        import pyarrow.parquet as pq
        return pq.read_schema(fname)

      def col_native(t) -> bool:
        # The authoritative type check: only what the C++ plane emits.
        if pa.types.is_list(t) or pa.types.is_large_list(t):
          t = t.value_type
          if pa.types.is_list(t) or pa.types.is_large_list(t):
            t = t.value_type   # rank 2 (list<list<T>>) is native
            if pa.types.is_list(t) or pa.types.is_large_list(t):
              return False     # rank >= 3 stays on the Python path
          return (pa.types.is_integer(t)
                  or pa.types.is_float32(t) or pa.types.is_float64(t))
        if pa.types.is_string(t) or pa.types.is_large_string(t):
          return True
        return (pa.types.is_integer(t)
                or pa.types.is_float32(t) or pa.types.is_float64(t))

      names = {f.name for f in self._fields}
      schema0 = read_schema(self._files[0])
      types0 = {f.name: f.type for f in schema0 if f.name in names}
      if len(types0) != len(names):
        return None
      if not all(col_native(t) for t in types0.values()):
        return None
      if len(self._files) > 1:
        # The native plane memcpy's with the first file's physical
        # types; ANY type drift across files (including string vs
        # large_string) must take the Python path, which upcasts.
        for fname in self._files[1:]:
          for f in read_schema(fname):
            if f.name in types0 and not f.type.equals(types0[f.name]):
              return None
      return native_tabular.NativeTabularIterator(
          self._files, list(self._task_indices()), self._fields,
          self._batch_size, drop_remainder=self._drop_remainder,
          shuffle=self._shuffle, shuffle_buffer=self._shuffle_buffer,
          seed=self._seed, threads=self._threads, format=self._format)
    except Exception:  # any native failure falls back to the Python path
      import logging
      logging.getLogger('hybridbackend_tpu').warning(
          'native data plane rejected this dataset; using Python path',
          exc_info=True)
      return None

  # -- tf.data-style combinators (reference datasets are tf.data;
  #    adoption parity for map/repeat/take/prefetch chains) -----------
  def map(self, fn):
    """Apply ``fn(batch) -> batch`` to every batch lazily."""
    return _map(self, fn)

  def repeat(self, n: Optional[int] = None):
    """Repeat the dataset ``n`` times (None = forever)."""
    return _repeat(self, n)

  def take(self, n: int):
    return _take(self, n)

  def prefetch(self, **kwargs):
    """Chain a background host→device ``DeviceIterator``."""
    return _prefetch(self, **kwargs)

  def dedup(self, value_columns: Sequence[str], key_column: str,
            index_column: str = 'restore_idx'):
    """Transport dedup stage: collapse rows with equal keys, adding a
    restore index (pair with ``.restore`` after prefetch). Reference:
    ``data/deduplicate/dataset.py:29-67``."""
    from hybridbackend_tpu.data.deduplicate import deduplicate
    cols, key, idx = list(value_columns), key_column, index_column
    return _map(self, lambda b: deduplicate(b, cols, key,
                                            index_column=idx))

  def restore(self, value_columns: Sequence[str],
              index_column: str = 'restore_idx'):
    """Re-expand columns collapsed by ``.dedup`` (or stored
    deduplicated). Reference restore inside ``.batch()``,
    ``tabular/table.py:218-223``."""
    from hybridbackend_tpu.data.deduplicate import restore_deduplicated
    cols, idx = list(value_columns), index_column
    return _map(self, lambda b: restore_deduplicated(b, cols, idx))

  def __iter__(self) -> Iterator[Batch]:
    if self._restore is None:
      it = self._native_iter()
      if it is not None:
        return it
    from hybridbackend_tpu.data.rebatch import rebatch
    micro = self._iter_micro_batches()
    if self._restore is not None:
      from hybridbackend_tpu.data.deduplicate import restore_deduplicated
      cols, idx = self._restore

      def _restored(src):
        for b in src:
          yield restore_deduplicated(b, cols, idx)
      micro = _restored(micro)
    return rebatch(micro, self._batch_size,
                   drop_remainder=self._drop_remainder,
                   shuffle=self._shuffle,
                   shuffle_buffer=self._shuffle_buffer,
                   seed=self._seed)


class _TransformedDataset:
  """Lazily transformed view of a dataset (tf.data-style combinators)."""

  def __init__(self, source, fn):
    self._source = source
    self._fn = fn

  def __iter__(self):
    return self._fn(self._source)

  # combinators chain on any dataset-like object
  map = lambda self, fn: _map(self, fn)
  repeat = lambda self, n=None: _repeat(self, n)
  take = lambda self, n: _take(self, n)
  prefetch = lambda self, **kw: _prefetch(self, **kw)
  dedup = ParquetDataset.dedup
  restore = ParquetDataset.restore


def _map(ds, fn):
  def gen(src):
    return (fn(b) for b in src)
  return _TransformedDataset(ds, gen)


def _repeat(ds, n=None):
  def gen(src):
    import itertools
    count = itertools.count() if n is None else range(n)
    for _ in count:
      yield from iter(src)
  return _TransformedDataset(ds, gen)


def _take(ds, n):
  def gen(src):
    it = iter(src)
    try:
      for _ in range(n):
        try:
          yield next(it)
        except StopIteration:
          return
    finally:
      close = getattr(it, 'close', None)
      if close is not None:
        close()
  return _TransformedDataset(ds, gen)


def _prefetch(ds, **kw):
  def gen(src):
    from hybridbackend_tpu.data.prefetch import DeviceIterator
    return DeviceIterator(iter(src), **kw)
  return _TransformedDataset(ds, gen)


class Dataset:
  """Namespace mirroring ``hb.data.Dataset.from_parquet/from_orc``
  (``data/__init__.py:30-46``)."""

  @staticmethod
  def from_parquet(filenames, **kwargs) -> ParquetDataset:
    return ParquetDataset(filenames, format='parquet', **kwargs)

  @staticmethod
  def from_orc(filenames, **kwargs) -> ParquetDataset:
    return ParquetDataset(filenames, format='orc', **kwargs)


__all__ = ['ParquetDataset', 'Dataset', 'infer_fields']
