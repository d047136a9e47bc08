"""End-to-end pipeline benchmark: data plane + train step TOGETHER.

The data plane and the train step, measured together. This harness
runs the reference's canonical deliverable shape — a Criteo-format
Parquet file (26 categorical ids + 13 dense float + label) through
``ParquetDataset`` → ``DeviceIterator`` prefetch → the flagship
stacked-DCNv2 sparse train step on the GPU — and reports
``e2e_examples_per_s`` plus the input-stall fraction — the fraction
of GROUP fetches (one fetch feeds G steps) that found the prefetch
queue empty; the denominator is group fetches, not steps.

Reference analogue: the taobao tutorial end-to-end loop
(``/root/reference/docs/tutorial/ranking/taobao/train.py:36-160``) fed
by the prefetch machinery
(``/root/reference/hybridbackend/tensorflow/data/prefetch/prefetch.cc:41-120``,
``iterator.py:45-407``).

The harness reads GROUPS of ``--group`` batches (one ``[G·B]`` decode,
reshaped to ``[G, B]`` — the rebatch plane produces the rows
contiguously, so the reshape is free) and runs one jitted ``lax.scan``
over the group: one dispatch per G steps, mirroring the reference's
multi-batch ``get_next`` pipelining (``iterators.py:74-272``). Group boundaries
still cross the host each time, so decode + H2D genuinely overlap
stepping through the DeviceIterator queue.

Usage:
  python benchmarks/e2e_benchmark.py [--batch 8192] [--group 16]
      [--steps 128] [--threads 0=auto] [--cpu N] [--json]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import json
import time

N_CAT = 26
N_DENSE = 13
VOCAB = 100_000


def _default_cache() -> str:
  """``<checkout>/.bench_cache`` (listed in .gitignore)."""
  return _os.path.join(_os.path.dirname(_os.path.dirname(
      _os.path.abspath(__file__))), '.bench_cache')


def _skewed_ids(rng, n: int, vocab: int):
  """Log-uniform (zipf-like) skewed ids — closed-form, unlike
  ``rng.zipf(a~1)`` whose rejection sampler is pathologically slow."""
  import numpy as np
  return np.minimum(np.exp(rng.rand(n) * np.log(vocab)).astype(np.int64),
                    vocab - 1)


def ensure_file(rows: int, seed: int = 0) -> str:
  """Criteo-shape synthetic Parquet: c0..c25 int32 ids (log-uniform
  skewed, like real CTR id frequencies), i0..i12 float32, int64
  label — the converter's output schema (int32 plain-encoded cats)."""
  cache = _os.environ.get('HB_BENCH_CACHE', _default_cache())
  path = _os.path.join(cache, f'e2e_criteo_{rows}.parquet')
  if _os.path.exists(path):
    return path
  _os.makedirs(cache, exist_ok=True)
  import numpy as np
  import pyarrow as pa
  import pyarrow.parquet as pq
  print(f'generating {path} ...', file=_sys.stderr)
  rng = np.random.RandomState(seed)
  writer = None
  slab = 131072
  done = 0
  while done < rows:
    n = min(slab, rows - done)
    data = {}
    for c in range(N_CAT):
      data[f'c{c}'] = _skewed_ids(rng, n, VOCAB).astype(np.int32)
    for d in range(N_DENSE):
      data[f'i{d}'] = rng.rand(n).astype(np.float32)
    data['label'] = rng.randint(0, 2, n)
    tbl = pa.table(data)
    if writer is None:
      # int32 + plain-encoded cats: the converter's real output format
      # (examples/criteo/convert.py) — high-card dictionary pages
      # decode slower than plain, and ids fit int32 after hash-mod.
      writer = pq.ParquetWriter(
          path, tbl.schema, compression='snappy',
          use_dictionary=[f'i{d}' for d in range(N_DENSE)] + ['label'])
    writer.write_table(tbl, row_group_size=32768)
    done += n
  writer.close()
  return path


def host_pipeline(path, group_rows, threads, stop):
  """Infinite epoch-cycling host iterator of [G·B]-row batches."""
  from hybridbackend_tpu.data import ParquetDataset
  while not stop.is_set():
    ds = ParquetDataset(path, batch_size=group_rows, drop_remainder=True,
                        num_parallel_reads=threads)
    for batch in ds:
      yield batch
      if stop.is_set():
        return


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--batch', type=int, default=8192)
  p.add_argument('--group', type=int, default=16,
                 help='train steps per dispatch')
  p.add_argument('--steps', type=int, default=128,
                 help='measured steps (after one warmup group)')
  p.add_argument('--threads', type=int, default=0)
  p.add_argument('--prefetch', type=int, default=2,
                 help='DeviceIterator capacity in GROUPS')
  p.add_argument('--cpu', type=int, default=0)
  p.add_argument('--json', action='store_true')
  p.add_argument('--profile', action='store_true',
                 help='synchronous per-stage timing (decode / pack / '
                      'put / step) instead of the pipelined benchmark')
  args = p.parse_args()

  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import threading

  import jax
  import jax.numpy as jnp
  import numpy as np
  import optax

  import hybridbackend_tpu as hb
  from hybridbackend_tpu.data.prefetch import DeviceIterator
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.models import EmbeddingSpec, StackedFeatureExtractor
  from hybridbackend_tpu.training import (SparseTrainState,
                                          make_sparse_train_step)
  from hybridbackend_tpu.models import stacked_dcn_v2_apply, stacked_dcn_v2_init

  ctx = hb.Context.get()
  B, G = args.batch, args.group
  group_rows = B * G
  threads = args.threads or min(_os.cpu_count() or 1, 20)
  # File sized to 4 group-batches per epoch (re-opened cyclically).
  path = ensure_file(4 * group_rows)

  specs = [EmbeddingSpec(TableConfig(f'c{i}', VOCAB, 16))
           for i in range(N_CAT)]
  dense_names = [f'i{d}' for d in range(N_DENSE)]
  key = jax.random.PRNGKey(0)
  k_tab, k_net = jax.random.split(key)
  net = stacked_dcn_v2_init(k_net, [16] * N_CAT + [1] * N_DENSE,
                            [1024, 512, 256, 1])
  fx = StackedFeatureExtractor(specs, dense_columns=dense_names, ctx=ctx)
  tables = fx.init(k_tab)

  def bce(preds, y):
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    return -jnp.mean(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))

  def model_loss(dense_params, emb_f, dense_f, batch):
    return bce(stacked_dcn_v2_apply(dense_params, emb_f + dense_f),
               batch['label']), {}

  state = SparseTrainState.create(net, tables, optax.adam(1e-3),
                                  adagrad_init=0.1, ctx=ctx)
  step = make_sparse_train_step(fx, model_loss, optax.adam(1e-3),
                                table_lr=0.05, ctx=ctx,
                                donate_state=False)

  def transform(batch):
    """Producer-thread prep: [G·B] columns -> TWO packed arrays
    ([C, G, B] int32 cats + [C, G, B] f32 dense|label): each put pays a
    fixed per-transfer overhead, so two packed puts replace 41, and the
    jitted group step unpacks by slicing (free under jit)."""
    # [C, G, B] layout: each column fills CONTIGUOUS memory (a
    # [G, C, B] layout would write strided; --profile times the
    # stages). The jitted group step swapaxes to scan-leading
    # [G, C, B] on device.
    cats = np.empty((N_CAT, G, B), np.int32)
    for i in range(N_CAT):
      cats[i] = batch[f'c{i}'].reshape(G, B)
    densel = np.empty((N_DENSE + 1, G, B), np.float32)
    for d in range(N_DENSE):
      densel[d] = batch[f'i{d}'].reshape(G, B)
    densel[N_DENSE] = batch['label'].reshape(G, B)
    return {'cats': cats, 'densel': densel}

  def group_step(st, groups):
    groups = {k: jnp.swapaxes(v, 0, 1) for k, v in groups.items()}
    def body(carry, packed):
      b = {f'c{i}': packed['cats'][i] for i in range(N_CAT)}
      b.update({f'i{d}': packed['densel'][d] for d in range(N_DENSE)})
      b['label'] = packed['densel'][N_DENSE]
      st2, m = step(carry, b)
      return st2, m['loss']
    st, losses = jax.lax.scan(body, st, groups)
    return st, losses[-1]

  gstep = jax.jit(group_step)

  if args.profile:
    # Localize the producer cost: run stages SYNCHRONOUSLY per group.
    stop = threading.Event()
    it0 = host_pipeline(path, group_rows, threads, stop)
    from hybridbackend_tpu.data.prefetch import _put_batch
    b0 = transform(next(it0))
    d0 = _put_batch(b0, ctx, True, 2)
    state, last = gstep(state, d0)
    _ = float(last)                      # compile
    for g in range(6):
      t0 = time.perf_counter()
      raw = next(it0)
      t1 = time.perf_counter()
      packed = transform(raw)
      t2 = time.perf_counter()
      dev = _put_batch(packed, ctx, True, 2)
      t3 = time.perf_counter()
      state, last = gstep(state, dev)
      t4 = time.perf_counter()
      _ = float(last)
      t5 = time.perf_counter()
      print(f'group {g}: decode {1000*(t1-t0):.0f} pack '
            f'{1000*(t2-t1):.0f} put-dispatch {1000*(t3-t2):.0f} '
            f'step-dispatch {1000*(t4-t3):.0f} complete '
            f'{1000*(t5-t4):.0f} ms', file=_sys.stderr, flush=True)
    stop.set()
    return

  stop = threading.Event()
  host_it = host_pipeline(path, group_rows, threads, stop)
  it = DeviceIterator(host_it, ctx=ctx, capacity=args.prefetch,
                      transform=transform, shard_dim=2)  # [G, C, B]: B is axis 2
  try:
    # Warmup: one group (compile + reader spin-up). Reset stall stats
    # after — the compile wait empties the queue by definition.
    groups = next(it)
    t0 = time.perf_counter()
    state, last = gstep(state, groups)
    _ = float(last)
    compile_s = time.perf_counter() - t0
    it.gets = it.stalls = 0
    it.stall_s = 0.0

    n_groups = max(1, args.steps // G)
    t0 = time.perf_counter()
    for _ in range(n_groups):
      groups = next(it)
      state, last = gstep(state, groups)
    _ = float(last)   # drain the enqueue pipeline
    wall = time.perf_counter() - t0
  finally:
    stop.set()
    it.close()

  steps = n_groups * G
  rows = steps * B
  stats = it.stall_stats
  result = {
      'metric': 'e2e_examples_per_s',
      'value': round(rows / wall, 1),
      'unit': 'examples/s',
      'e2e_ms_per_step': round(1000.0 * wall / steps, 3),
      'steps': steps,
      'group': G,
      'batch': B,
      # Fraction of GROUP fetches that waited on the queue (one fetch
      # feeds G steps — denominator is fetches, not steps).
      'stall_fraction': round(stats['stall_fraction'], 4),
      'group_fetches': stats['gets'],
      'stalls': stats['stalls'],
      'stall_s': round(stats['stall_s'], 3),
      'decode_threads': threads,
      'host_cpus': _os.cpu_count(),
      'platform': jax.devices()[0].platform,
      'device_kind': jax.devices()[0].device_kind,
      'device_count': len(jax.devices()),
      'compile_s': round(compile_s, 1),
  }
  if args.json:
    print(json.dumps(result))
  else:
    for k, v in result.items():
      print(f'{k:>18}: {v}')


if __name__ == '__main__':
  main()
