"""Headline benchmark: the reference's own data-loading protocol, plus
the flagship train step and the end-to-end pipeline on the GPU.

Data plane: replicates ``/root/reference/hybridbackend/tensorflow/
benchmarks/data_benchmark_parquet.py:40-117`` and the published table in
``docs/data.md:265-285``: a mock Parquet file of ``batch_size * 100``
rows × 200 int64 columns (values 0..100, SNAPPY), read in batches of
20000 for 100 steps; report average msec/step.

Reference numbers (96-vCPU Xeon 8163 + SSD): 397.88 ms/step at 1 thread,
21.67 ms/step at 20 threads. ``vs_baseline`` compares against the
thread-count-appropriate reference number for this host (>1 = faster).

Device phases: the flagship stacked-DCNv2 sparse step (26 tables ×
dim 16, batch 8192, Adagrad tables + Adam dense) via
``benchmarks/train_benchmark.py``, then the Parquet → ``DeviceIterator``
→ step pipeline via ``benchmarks/e2e_benchmark.py`` (the reference
publishes its training throughput only in the PICASSO paper — this is
the measurable stand-in). Each runs in a child process, and this parent
never initializes JAX: a JAX process reserves most of the card's memory,
so only one process may hold the card. A child that finds no GPU fails,
and then this script fails; it never reports a CPU run as a device
result. ``--scaling`` runs only the host decode-thread table.

Prints ONE JSON line:
  {"metric": "parquet_read_ms_per_step", "value": ..., "unit":
   "ms/step", "vs_baseline": ..., "train_step_ms": ...,
   "examples_per_s": ..., "platform": "gpu", "device_kind": ...,
   "device_count": ..., "e2e_examples_per_s": ..., ...}
"""

import json
import os
import sys
import time

BATCH = 20000
COLS = 200
STEPS = 100


HERE = os.path.dirname(os.path.abspath(__file__))
# The 3.2 GB mock file; ``warm_page_cache`` faults it in before timing
# (the reference measured on an SSD-cached file, docs/data.md:283-285).
CACHE = os.environ.get('HB_BENCH_CACHE', os.path.join(HERE, '.bench_cache'))
REF_MS_1T = 397.88   # docs/data.md:279 (1 thread)
REF_MS_20T = 21.67   # docs/data.md:280 (20 threads)


def ensure_file() -> str:
  path = os.path.join(CACHE, f'benchmark_{BATCH}x{COLS}.parquet')
  if os.path.exists(path):
    return path
  os.makedirs(CACHE, exist_ok=True)
  import numpy as np
  import pyarrow as pa
  import pyarrow.parquet as pq
  print(f'generating mock file {path} ...', file=sys.stderr)
  rng = np.random.RandomState(0)
  # Write in slabs to bound memory; row_group_size matches reference
  # pandas default behavior (1Mi rows per group would starve the
  # parallel reader; 100k keeps 20 read units).
  writer = None
  rows_per_slab = BATCH * 10
  for _ in range(10):
    data = {f'f{c}': rng.randint(0, 100, rows_per_slab)
            for c in range(COLS)}
    tbl = pa.table(data)
    if writer is None:
      writer = pq.ParquetWriter(path, tbl.schema, compression='snappy')
    writer.write_table(tbl, row_group_size=BATCH)
  writer.close()
  return path


def warm_page_cache(path: str) -> None:
  """Fault the whole file into the page cache so the measurement is the
  decode pipeline, not disk state (the reference's protocol averages
  repeated passes on an SSD-cached file, docs/data.md:283-285)."""
  with open(path, 'rb') as f:
    while f.read(1 << 24):
      pass


def measure(path, threads, passes=9):
  from hybridbackend_tpu.data import ParquetDataset
  ds = ParquetDataset(path, batch_size=BATCH, drop_remainder=True,
                      num_parallel_reads=threads)

  def one_pass() -> float:
    it = iter(ds)
    next(it)  # warm (open readers, build the native pipeline)
    start = time.time()
    count = 0
    for batch in it:
      count += 1
    return 1000.0 * (time.time() - start) / max(count, 1)

  one_pass()  # untimed warmup: native .so build, allocator pools, page
              # cache make the first pass an outlier
  return sorted(one_pass() for _ in range(passes))


def _child(script, *args, timeout):
  """Run a device benchmark in a child process; its last stdout line is
  its JSON result. Raises when the child fails (no GPU included)."""
  import subprocess
  proc = subprocess.run(
      [sys.executable, os.path.join(HERE, 'benchmarks', script), '--json',
       *args], capture_output=True, text=True, timeout=timeout)
  if proc.returncode != 0:
    raise RuntimeError(f'{script} failed ({proc.returncode}):\n'
                       f'{proc.stderr[-4000:]}')
  return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
  path = ensure_file()
  threads = int(os.environ.get('HB_BENCH_THREADS', 0)) or min(
      os.cpu_count() or 1, 20)
  warm_page_cache(path)

  if '--scaling' in sys.argv:
    # Decode-thread scaling table (reference protocol docs/data.md:283).
    for t in (1, 2, 4, 8, 16, 20):
      if t > (os.cpu_count() or 1):
        break
      p = measure(path, t, passes=3)
      print(json.dumps({'threads': t, 'median_ms': round(p[len(p) // 2], 2),
                        'spread_ms': [round(x, 2) for x in p]}))
    return

  # Median of 9 passes; headline spread is TRIMMED (min and max pass
  # dropped) so one noisy-neighbor outlier on a shared host does not
  # dominate it, while the full distribution is still reported raw.
  passes = measure(path, threads)
  ms_per_step = passes[len(passes) // 2]
  trimmed = passes[1:-1]

  ref = REF_MS_20T if threads >= 20 else REF_MS_1T
  result = {
      'metric': 'parquet_read_ms_per_step',
      'value': round(ms_per_step, 2),
      'unit': 'ms/step',
      'vs_baseline': round(ref / ms_per_step, 2),
      'spread_ms': [round(p, 2) for p in trimmed],
      'spread_raw_ms': [round(p, 2) for p in passes],
      'threads': threads,
      'host_cpus': os.cpu_count(),
  }
  train = _child('train_benchmark.py', '--sparse', '--steps', '50',
                 timeout=900)
  result['train_step_ms'] = train['ms_per_step']
  result['examples_per_s'] = train['value']
  for k in ('platform', 'device_kind', 'device_count'):
    result[k] = train[k]
  e2e = _child('e2e_benchmark.py', '--steps', '128', timeout=2700)
  result['e2e_examples_per_s'] = e2e['value']
  result['e2e_ms_per_step'] = e2e['e2e_ms_per_step']
  result['e2e_stall_fraction'] = e2e['stall_fraction']
  result['e2e_vs_step_only'] = round(
      e2e['value'] / max(result['examples_per_s'], 1), 3)
  result['e2e_device'] = [e2e[k] for k in
                          ('platform', 'device_kind', 'device_count')]
  print(json.dumps(result))


if __name__ == '__main__':
  main()
