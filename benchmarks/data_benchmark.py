"""Data-loading benchmark CLI (parquet / dedup / transfer).

Port of the reference's ``data_benchmark_parquet.py`` /
``data_benchmark_deduplication.py`` / ``transfer_benchmark.py``
(``/root/reference/hybridbackend/tensorflow/benchmarks/``). The default
protocol matches the published table in ``docs/data.md:265-285`` (also
what the repo-root ``bench.py`` reports).

Usage: python benchmarks/data_benchmark.py [--mode parquet|dedup|transfer]
       [--batch 20000] [--cols 200] [--steps 100] [--threads N]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import os
import tempfile
import time

import numpy as np


def bench_parquet(args):
  import pyarrow as pa
  import pyarrow.parquet as pq
  from hybridbackend_tpu.data import ParquetDataset
  path = os.path.join(args.workdir, 'bench.parquet')
  if not os.path.exists(path):
    rng = np.random.RandomState(0)
    writer = None
    for _ in range(args.steps // 10 or 1):
      tbl = pa.table({f'f{c}': rng.randint(0, 100, args.batch * 10)
                      for c in range(args.cols)})
      if writer is None:
        writer = pq.ParquetWriter(path, tbl.schema, compression='snappy')
      writer.write_table(tbl, row_group_size=args.batch)
    writer.close()
  ds = ParquetDataset(path, batch_size=args.batch, drop_remainder=True,
                      num_parallel_reads=args.threads)
  it = iter(ds)
  next(it)
  t0 = time.time()
  count = sum(1 for _ in it)
  dt = (time.time() - t0) / max(count, 1)
  print(f'parquet: {dt * 1e3:.2f} ms/step, '
        f'{args.batch / dt:,.0f} samples/sec '
        f'({count} steps, {args.threads} threads)')


def bench_csv(args):
  """CSV baseline (reference ``data_benchmark_csv.py``): same rows read
  through pandas' C engine in batch-size chunks — the 'vanilla' number
  the published table compares Parquet against (docs/data.md:275-277).
  Also reports the storage ratio (reference claims >=3.3x)."""
  import pandas as pd
  path = os.path.join(args.workdir, 'bench.csv')
  rows = args.batch * max(args.steps // 10, 1)
  if not os.path.exists(path):
    rng = np.random.RandomState(0)
    pd.DataFrame({f'f{c}': rng.randint(0, 100, rows)
                  for c in range(args.cols)}).to_csv(path, index=False)
  t0 = time.time()
  count = 0
  for chunk in pd.read_csv(path, chunksize=args.batch, engine='c'):
    count += 1
  dt = (time.time() - t0) / max(count, 1)
  pq_path = os.path.join(args.workdir, 'bench.parquet')
  size_note = ''
  if os.path.exists(pq_path):
    import pyarrow.parquet as pq
    pq_rows = pq.ParquetFile(pq_path).metadata.num_rows
    csv_per_row = os.path.getsize(path) / rows
    pq_per_row = os.path.getsize(pq_path) / pq_rows
    size_note = (f', csv/parquet bytes-per-row ratio '
                 f'{csv_per_row / pq_per_row:.2f}x')
  print(f'csv: {dt * 1e3:.2f} ms/step, {args.batch / dt:,.0f} '
        f'samples/sec ({count} steps){size_note}')


def bench_dedup(args):
  from hybridbackend_tpu.data import deduplicate, restore_deduplicated
  rng = np.random.RandomState(0)
  n = args.batch
  batch = {
      'user': rng.randint(0, n // 10, n),
      'profile': rng.rand(n, 64).astype(np.float32),
      'item': rng.randint(0, 100000, n),
  }
  t0 = time.time()
  for _ in range(args.steps):
    dd = deduplicate(batch, ['profile'], 'user')
  dt = (time.time() - t0) / args.steps
  ratio = len(dd['profile']) / n
  t0 = time.time()
  for _ in range(args.steps):
    restore_deduplicated(dd, ['profile'], 'restore_idx')
  dr = (time.time() - t0) / args.steps
  print(f'dedup: {dt * 1e3:.2f} ms, restore: {dr * 1e3:.2f} ms '
        f'({n} rows, unique ratio {ratio:.2f})')


def bench_transfer(args):
  import jax
  import hybridbackend_tpu as hb
  ctx = hb.Context.get()
  x = np.random.rand(args.batch, args.cols).astype(np.float32)
  jax.device_put(x, ctx.batch_sharding).block_until_ready()
  t0 = time.time()
  for _ in range(args.steps):
    r = jax.device_put(x, ctx.batch_sharding)
  r.block_until_ready()
  dt = (time.time() - t0) / args.steps
  print(f'h2d transfer: {dt * 1e3:.3f} ms/step, '
        f'{x.nbytes / dt / 1e9:.2f} GB/s ({x.nbytes / 1e6:.1f} MB)')


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--mode', default='parquet',
                 choices=['parquet', 'csv', 'dedup', 'transfer'])
  p.add_argument('--batch', type=int, default=20000)
  p.add_argument('--cols', type=int, default=200)
  p.add_argument('--steps', type=int, default=100)
  p.add_argument('--threads', type=int, default=os.cpu_count() or 1)
  p.add_argument('--workdir',
                 default=os.environ.get('HB_BENCH_CACHE', os.path.join(
                     os.path.dirname(os.path.dirname(
                         os.path.abspath(__file__))), '.bench_cache')))
  args = p.parse_args()
  os.makedirs(args.workdir, exist_ok=True)
  {'parquet': bench_parquet, 'csv': bench_csv, 'dedup': bench_dedup,
   'transfer': bench_transfer}[args.mode](args)


if __name__ == '__main__':
  main()
