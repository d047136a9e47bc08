"""Criteo wide&deep training (stacked DCNv2 or DLRM).

A JAX port of the reference tutorial
(``/root/reference/docs/tutorial/ranking/criteo/train.py``): 13 dense +
26 categorical Criteo columns, per-column sharded embedding tables
(stacked into fused physical tables), DCNv2 or DLRM tower, Adagrad on
tables + Adam on dense, AUC eval, checkpointing.

With ``--synthesize``, generates a Criteo-shaped Parquet sample so the
script runs anywhere:

  python examples/criteo/train.py --synthesize --steps 200
  python -m hybridbackend_tpu.run examples/criteo/train.py --data ...
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))


import argparse
import os

import numpy as np

NUM_DENSE = 13
NUM_CAT = 26


def synthesize(path: str, rows: int, vocabs) -> None:
  import pandas as pd
  rng = np.random.RandomState(0)
  cols = {}
  # Planted signal so AUC is meaningful: label depends on a few columns.
  signal = np.zeros(rows)
  for c in range(NUM_CAT):
    ids = rng.zipf(1.5, rows) % vocabs[c]
    cols[f'c{c}'] = ids.astype(np.int64)
    if c < 4:
      signal = signal + (ids % 5 == 0) * 0.8
  for d in range(NUM_DENSE):
    v = rng.exponential(1.0, rows).astype(np.float32)
    cols[f'i{d}'] = v
    if d < 2:
      signal = signal + 0.3 * np.log1p(v)
  p = 1.0 / (1.0 + np.exp(-(signal - signal.mean())))
  cols['label'] = (rng.rand(rows) < p).astype(np.float32)
  pd.DataFrame(cols).to_parquet(path, row_group_size=8192)


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--data', default='')
  p.add_argument('--synthesize', action='store_true')
  p.add_argument('--rows', type=int, default=100_000)
  p.add_argument('--model', default='dcnv2', choices=['dcnv2', 'dlrm'])
  p.add_argument('--model-dir', default='')
  p.add_argument('--batch-size', type=int, default=4096)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--vocab', type=int, default=100_000)
  p.add_argument('--steps', type=int, default=None)
  p.add_argument('--epochs', type=int, default=1)
  p.add_argument('--lr-tables', type=float, default=0.05)
  p.add_argument('--lr-dense', type=float, default=1e-3)
  p.add_argument('--sparse', action='store_true',
                 help='row-sparse table updates (no dense [V,D] grads)')
  p.add_argument('--export', default='', metavar='DIR',
                 help='sparse mode: export a standalone serving bundle '
                      'after training')
  p.add_argument('--export-poly', action='store_true',
                 help='export with a symbolic batch dimension (one '
                      'bundle serves any batch size)')
  p.add_argument('--export-int8', action='store_true',
                 help='quantize exported tables to per-row int8 '
                      '(4x smaller bundle)')
  p.add_argument('--cached', type=int, default=0, metavar='CAP',
                 help='EmbeddingService demo (implies --sparse): keep '
                      'the largest table in host DRAM behind a CAP-row '
                      'HBM cache (LRU write-back, id->slot native '
                      'hash)')
  p.add_argument('--lookup', default='allgather',
                 choices=['allgather', 'alltoall', 'gspmd', 'hierarchical'])
  p.add_argument('--cpu', type=int, default=0,
                 help='simulate N CPU devices')
  args = p.parse_args()

  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import jax
  import jax.numpy as jnp
  import optax
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor, dlrm_apply, dlrm_init,
      stacked_dcn_v2_apply, stacked_dcn_v2_init)
  from hybridbackend_tpu.training import (
      LoggingHook, SparseTrainState, StepStatHook, make_sparse_train_step,
      multi_optimizer)

  vocabs = [max(100, args.vocab >> (c % 5)) for c in range(NUM_CAT)]
  if not args.data:
    args.data = '/tmp/criteo_sample.parquet'
    args.synthesize = not os.path.exists(args.data)
  if args.synthesize:
    print(f'synthesizing {args.rows} rows → {args.data}')
    synthesize(args.data, args.rows, vocabs)

  hb.OPTIONS['emb_lookup_strategy'] = args.lookup
  caches = None
  if args.cached:
    # EmbeddingService parity demo: the LARGEST table lives in host
    # DRAM behind a fixed-capacity HBM cache; its ids are host-mapped
    # to cache slots every step (reference service.py:50-324).
    args.sparse = True
    import numpy as _np
    from hybridbackend_tpu.embedding import EmbeddingCache
    big = int(_np.argmax(vocabs))
    rngc = _np.random.RandomState(42)
    cache = EmbeddingCache(
        TableConfig(f'c{big}', vocabs[big], args.dim), int(args.cached),
        host_tables={
            'value': (rngc.randn(vocabs[big], args.dim) * 0.01
                      ).astype(_np.float32),
            'slot0': _np.full((vocabs[big], args.dim), 0.1, _np.float32),
        })
    caches = {f'c{big}': cache}
    specs = [EmbeddingSpec(cache.slot_config() if c == big else
                           TableConfig(f'c{c}', vocabs[c], args.dim),
                           column=f'c{c}')
             for c in range(NUM_CAT)]
  else:
    specs = [EmbeddingSpec(TableConfig(f'c{c}', vocabs[c], args.dim))
             for c in range(NUM_CAT)]
  dense_cols = [f'i{d}' for d in range(NUM_DENSE)]
  fx = StackedFeatureExtractor(specs, dense_columns=dense_cols)

  key = jax.random.PRNGKey(0)
  k_tab, k_net = jax.random.split(key)
  params = {'tables': fx.init(k_tab)}
  if args.model == 'dcnv2':
    params['net'] = stacked_dcn_v2_init(
        k_net, [args.dim] * NUM_CAT + [1] * NUM_DENSE, [1024, 256, 32, 1])
  else:
    params['net'] = dlrm_init(k_net, NUM_DENSE, NUM_CAT,
                              [512, 256], args.dim, [1024, 256, 1])

  def loss_fn(params, batch):
    emb, dense = fx(params['tables'], batch)
    if args.model == 'dcnv2':
      preds = stacked_dcn_v2_apply(params['net'], emb + dense)
    else:
      preds = dlrm_apply(params['net'], dense, emb)
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    y = batch['label']
    pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}

  if args.sparse:
    # Row-sparse table path: tables updated on touched rows only.
    def model_loss(dense_params, emb_f, dense_f, batch):
      if args.model == 'dcnv2':
        preds = stacked_dcn_v2_apply(dense_params, emb_f + dense_f)
      else:
        preds = dlrm_apply(dense_params, dense_f, emb_f)
      preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
      y = batch['label']
      pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
      return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}

    ctx0 = hb.Context.get()
    strainer = hb.estimator.SparseTrainer(
        fx, model_loss, params['net'], tables=params['tables'],
        dense_optimizer=optax.adam(args.lr_dense),
        table_lr=args.lr_tables,
        model_dir=args.model_dir or None,
        caches=caches)

    def sparse_batches(shuffle):
      ds = hb.data.Dataset.from_parquet(
          args.data, batch_size=args.batch_size, drop_remainder=True,
          shuffle=shuffle, partition_index=ctx0.rank,
          partition_count=ctx0.num_processes)
      return iter(ds)

    for epoch in range(args.epochs):
      import time as _t
      t0 = _t.time()
      m = strainer.train(sparse_batches(True), max_steps=args.steps or None)
      dt = _t.time() - t0
      res = strainer.evaluate(sparse_batches(False))
      print(f'epoch {epoch}: loss={m["loss"]:.4f}, '
            f'auc={res["auc"]:.4f}, {dt:.1f}s')
    if args.export:
      example = next(sparse_batches(False))
      path = strainer.export_saved_model(
          args.export, example,
          table_dtype='int8' if args.export_int8 else 'float32',
          poly_batch=args.export_poly)
      if hb.Context.get().is_chief:
        print(f'exported serving bundle → {path}'
              + (' (int8 tables)' if args.export_int8 else ''))
    return

  opt = multi_optimizer(optax.adagrad(args.lr_tables),
                        optax.adam(args.lr_dense))(params)
  trainer = hb.Trainer(loss_fn, params, opt,
                       model_dir=args.model_dir or None)

  ctx = hb.Context.get()

  def train_batches():
    ds = hb.data.Dataset.from_parquet(
        args.data, batch_size=args.batch_size, drop_remainder=True,
        shuffle=True, partition_index=ctx.rank,
        partition_count=ctx.num_processes)
    return iter(ds)

  def eval_batches():
    ds = hb.data.Dataset.from_parquet(
        args.data, batch_size=args.batch_size, drop_remainder=True,
        partition_index=ctx.rank, partition_count=ctx.num_processes)
    return iter(ds)

  hooks = [StepStatHook(batch_size=args.batch_size, every_n_steps=50,
                        log=print),
           LoggingHook(every_n_steps=50, log=print)]
  for epoch in range(args.epochs):
    trainer.train(train_batches(), max_steps=args.steps, hooks=hooks)
    results = trainer.evaluate(eval_batches())
    print(f'epoch {epoch}: {results}')


if __name__ == '__main__':
  main()
