"""Serving-path latency benchmark.

The exported ``Served`` bundle was correctness-tested but never timed.
This harness exports the flagship stacked-DCNv2 ranking model (26
tables x dim 16) as f32 and int8 bundles plus a DIN ragged-signature
bundle, then measures on the current backend:

  * export time,
  * cold-load time (``Served(path)`` construction) and first-predict
    (compile) time,
  * per-batch serve latency at b in {128, 1024, 8192} — AMORTIZED over
    ``--inner`` dispatches with one readback (async dispatch + final
    readback isolates device+dispatch cost, the number a co-located
    server would see),
  * the one-call round-trip latency, reported separately.

Reference: export doctrine ``saved_model.py:54-192``; int8's claim is
capacity (4x vocab per chip); its latency against f32 on the GPU is
what this harness measures.

Usage: python benchmarks/serving_benchmark.py [--inner 20] [--json]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import json
import shutil
import tempfile
import time

N_CAT, N_DENSE, VOCAB, DIM = 26, 13, 100_000, 16


def _flagship_bundles(tmp, ctx, steps=2):
  import jax
  import jax.numpy as jnp
  import numpy as np
  import optax
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.estimator import SparseTrainer
  from hybridbackend_tpu.models import (EmbeddingSpec,
                                        StackedFeatureExtractor,
                                        stacked_dcn_v2_apply,
                                        stacked_dcn_v2_init)

  specs = [EmbeddingSpec(TableConfig(f'c{i}', VOCAB, DIM))
           for i in range(N_CAT)]
  dense = [f'i{d}' for d in range(N_DENSE)]
  fx = StackedFeatureExtractor(specs, dense_columns=dense, ctx=ctx)
  net = stacked_dcn_v2_init(jax.random.PRNGKey(1),
                            [DIM] * N_CAT + [1] * N_DENSE,
                            [1024, 512, 256, 1])

  def mloss(net_params, emb_f, dense_f, batch):
    preds = stacked_dcn_v2_apply(net_params, emb_f + dense_f)
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    y = batch['label']
    pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}

  tr = SparseTrainer(fx, mloss, net, rng=jax.random.PRNGKey(0),
                     model_dir=None, ctx=ctx)
  rng = np.random.RandomState(0)

  def mk_batch(b):
    out = {f'c{i}': rng.randint(0, VOCAB, b).astype(np.int32)
           for i in range(N_CAT)}
    out.update({d: rng.rand(b).astype(np.float32) for d in dense})
    out['label'] = rng.randint(0, 2, b).astype(np.float32)
    return out

  if steps:
    tr.train(iter([mk_batch(512) for _ in range(steps)]), sync=False,
             prefetch=False)
  out = {}
  for dtype in ('float32', 'int8'):
    path = _os.path.join(tmp, f'flagship_{dtype}')
    t0 = time.perf_counter()
    tr.export_saved_model(path, mk_batch(512), table_dtype=dtype,
                          poly_batch=True)
    out[dtype] = (path, time.perf_counter() - t0)
  return out, mk_batch


def _din_bundle(tmp, ctx):
  import jax
  import jax.numpy as jnp
  import numpy as np
  import optax
  from hybridbackend_tpu.embedding import TableConfig, lookup
  from hybridbackend_tpu.estimator import Trainer
  from hybridbackend_tpu.models import din_apply, din_init, init_tables
  from hybridbackend_tpu.models import EmbeddingSpec

  item_cfg = TableConfig('item', 50_000, DIM)
  user_cfg = TableConfig('user', 20_000, DIM)
  specs = [EmbeddingSpec(item_cfg), EmbeddingSpec(user_cfg)]
  params = {'tables': init_tables(specs, jax.random.PRNGKey(0)),
            'net': din_init(jax.random.PRNGKey(1), DIM,
                            num_profile_features=1, num_dense=0)}

  def loss_fn(params, batch):
    q = lookup(params['tables']['item'], batch['item'], item_cfg)
    keys = lookup(params['tables']['item'], batch['hist'], item_cfg)
    prof = lookup(params['tables']['user'], batch['user'], user_cfg)
    preds = din_apply(params['net'], q, keys, batch['hist_mask'], [prof])
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    y = batch['label']
    pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}

  tr = Trainer(loss_fn, params,
               optimizer=None, model_dir=None, ctx=ctx)
  rng = np.random.RandomState(0)

  def mk_batch(b, L=32):
    return {'item': rng.randint(0, 50_000, b).astype(np.int32),
            'user': rng.randint(0, 20_000, b).astype(np.int32),
            'hist': rng.randint(0, 50_000, (b, L)).astype(np.int32),
            'hist_mask': (rng.rand(b, L) < 0.6),
            'label': rng.randint(0, 2, b).astype(np.float32)}

  path = _os.path.join(tmp, 'din')
  t0 = time.perf_counter()
  tr.export_saved_model(path, mk_batch(512), poly_batch=True)
  return (path, time.perf_counter() - t0), mk_batch


def bench_bundle(path, mk_batch, sizes, inner, repeats):
  """Cold-load + per-batch latency of one exported bundle."""
  import numpy as np
  from hybridbackend_tpu.training.saved_model import Served
  t0 = time.perf_counter()
  served = Served(path)
  load_s = time.perf_counter() - t0
  r = {'cold_load_s': round(load_s, 2), 'batches': {}}
  for b in sizes:
    batch = mk_batch(b)
    # Device-stage the inputs once (public API): the amortized metric
    # isolates the serving fn (a server keeps its input buffers
    # device-adjacent); the roundtrip metric below goes through
    # predict() with raw host numpy, paying the real H2D + D2H.
    staged = served.stage(batch)
    t0 = time.perf_counter()
    first = np.asarray(served.predict_staged(staged))
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
      t0 = time.perf_counter()
      out = None
      for _ in range(inner):
        out = served.predict_staged(staged)
      _ = float(np.asarray(out).ravel()[0])
      times.append((time.perf_counter() - t0) / inner)
    t1 = time.perf_counter()
    _ = np.asarray(served.predict(batch))
    rt = time.perf_counter() - t1
    r['batches'][b] = {
        'amortized_ms': round(1000.0 * min(times), 3),
        'roundtrip_ms': round(1000.0 * rt, 1),
        'first_call_s': round(first_s, 2),
    }
    assert np.isfinite(first).all()
  return r


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--inner', type=int, default=20)
  p.add_argument('--train-steps', type=int, default=2,
                 help='train steps before export (0 skips the train-'
                      'step compile entirely — latency does not need '
                      'trained weights)')
  p.add_argument('--repeats', type=int, default=3)
  p.add_argument('--sizes', type=int, nargs='*', default=[128, 1024, 8192])
  p.add_argument('--cpu', type=int, default=0)
  p.add_argument('--cases', nargs='*', default=['f32', 'int8', 'din'])
  p.add_argument('--json', action='store_true')
  args = p.parse_args()
  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import jax
  import hybridbackend_tpu as hb
  ctx = hb.Context.get()

  dev = jax.devices()[0]
  results = {'platform': dev.platform, 'device_kind': dev.device_kind,
             'device_count': len(jax.devices())}
  tmp = tempfile.mkdtemp(prefix='hbtpu_serve_')
  try:
    if 'f32' in args.cases or 'int8' in args.cases:
      bundles, mk_batch = _flagship_bundles(tmp, ctx,
                                            steps=args.train_steps)
      for name, dtype in (('f32', 'float32'), ('int8', 'int8')):
        if name not in args.cases:
          continue
        path, export_s = bundles[dtype]
        r = bench_bundle(path, mk_batch, args.sizes, args.inner,
                         args.repeats)
        r['export_s'] = round(export_s, 2)
        r['bundle_mb'] = round(sum(
            _os.path.getsize(_os.path.join(dp, f))
            for dp, _, fs in _os.walk(path) for f in fs) / 1e6, 1)
        results[f'flagship_{name}'] = r
        print(f'flagship_{name}: {r}', file=_sys.stderr, flush=True)
    if 'din' in args.cases:
      (path, export_s), mk_din = _din_bundle(tmp, ctx)
      r = bench_bundle(path, mk_din, [b for b in args.sizes if b <= 1024],
                       args.inner, args.repeats)
      r['export_s'] = round(export_s, 2)
      results['din_ragged'] = r
      print(f'din_ragged: {r}', file=_sys.stderr, flush=True)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  print(json.dumps(results))


if __name__ == '__main__':
  main()
