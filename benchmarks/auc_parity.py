"""AUC-convergence parity: exact dense baseline vs the full fast path.

The repo proves step-level exactness extensively; this harness proves
TRAINING-QUALITY parity (round-4 order #4, the reference's north star —
its canonical tutorials train to reference AUC,
``/root/reference/docs/tutorial/ranking/taobao/train.py:36-160``):

* a deterministic synthetic CTR set with a planted NONLINEAR signal
  (XOR of two per-id latent bits + a marginal bit + a dense term) is
  generated to Parquet — the model must LEARN embeddings to separate;
* the ``exact`` variant trains the dense-update baseline (tables in
  params, full [V, D] Adagrad) at several seeds → the run-to-run noise
  band;
* the ``fast`` variant trains the full fast path — row-sparse table
  updates + bucketed exchanges at default ratios + bf16 wire;
* the ``fast_overflow`` variant shrinks the bucket/unique capacities so
  the exact overflow fallbacks FIRE (the harness verifies they must,
  from the data) and asserts quality is unharmed.

Final eval AUC of every fast variant must land inside the exact
baseline's noise band (+ a small margin).

Usage:
  python benchmarks/auc_parity.py [--rows 1048576] [--json] [--cpu N]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import json
import math
import os
import time

import numpy as np

_VOCAB_SEED = 1234567


def _latent_bits(vocab: int, col: int) -> np.ndarray:
  """Deterministic per-id latent bit for column ``col`` (the signal the
  embeddings must recover)."""
  rng = np.random.RandomState(_VOCAB_SEED + col)
  return (rng.rand(vocab) < 0.5)


def synthesize(path: str, rows: int, tables: int, vocab: int,
               seed: int) -> None:
  """Parquet CTR sample: zipf categorical ids, exponential dense, label
  from XOR(b0, b1) + b2 + tanh(dense) — nonlinear in the ids."""
  import pandas as pd
  rng = np.random.RandomState(seed)
  cols = {}
  bits = {}
  for c in range(tables):
    ids = (rng.zipf(1.3, rows) % vocab).astype(np.int64)
    cols[f'c{c}'] = ids
    if c < 3:
      bits[c] = _latent_bits(vocab, c)[ids]
  i0 = rng.exponential(1.0, rows).astype(np.float32)
  cols['i0'] = i0
  cols['i1'] = rng.exponential(1.0, rows).astype(np.float32)
  signal = (2.2 * (bits[0] ^ bits[1]).astype(np.float32)
            + 0.9 * bits[2].astype(np.float32)
            + 0.6 * np.tanh(i0 - 1.0))
  p = 1.0 / (1.0 + np.exp(-(signal - signal.mean())))
  cols['label'] = (rng.rand(rows) < p).astype(np.float32)
  pd.DataFrame(cols).to_parquet(path, row_group_size=max(8192, rows // 64))


def _overflow_expected(train_path, tables, batch, world, lookup_ratio,
                       update_ratio):
  """Recompute the bucket occupancies of the FIRST batch in NumPy and
  report whether any per-peer bucket must overflow — the out-of-band
  proof that the lax.cond fallbacks fire in the overflow variant."""
  import pandas as pd
  df = pd.read_parquet(train_path).iloc[:batch]
  lookup_cap = max(1, math.ceil(lookup_ratio * (batch / world) / world))
  update_cap = max(1, math.ceil(update_ratio *
                                math.ceil((batch * tables / world) / world)))
  fired = False
  for c in range(tables):
    ids = df[f'c{c}'].to_numpy()
    for dev in range(world):
      local = np.unique(ids[dev * (batch // world):
                            (dev + 1) * (batch // world)])
      owner_counts = np.bincount(local % world, minlength=world)
      if owner_counts.max() > lookup_cap:
        fired = True
  return fired, {'lookup_cap': lookup_cap, 'update_cap': update_cap}


def run_variant(name, train_path, eval_path, *, tables, vocab, dim,
                batch, epochs, steps, seed, table_lr, dense_lr,
                options):
  """Train one variant to completion; returns (final_auc, curve)."""
  import jax
  import optax
  import jax.numpy as jnp
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor, stacked_dcn_v2_apply,
      stacked_dcn_v2_init)
  from hybridbackend_tpu.training import multi_optimizer

  dense_cols = ['i0', 'i1']
  ctx = hb.Context.get()

  def batches(path, shuffle, bseed):
    ds = hb.data.Dataset.from_parquet(
        path, batch_size=batch, drop_remainder=True, shuffle=shuffle,
        seed=bseed, partition_index=ctx.rank,
        partition_count=ctx.num_processes)
    return iter(ds)

  def bce(preds, y):
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return jnp.mean(pel), pel

  key = jax.random.PRNGKey(seed)
  k_tab, k_net = jax.random.split(key)
  net0 = stacked_dcn_v2_init(k_net, [dim] * tables + [1] * len(dense_cols),
                             [256, 64, 1])
  curve = []
  with hb.scope(**options):
    specs = [EmbeddingSpec(TableConfig(f'c{c}', vocab, dim))
             for c in range(tables)]
    fx = StackedFeatureExtractor(specs, dense_columns=dense_cols)

    if name.startswith('exact'):
      params = {'tables': fx.init(k_tab), 'net': net0}

      def loss_fn(params, b):
        emb, dense = fx(params['tables'], b)
        preds = stacked_dcn_v2_apply(params['net'], emb + dense)
        loss, pel = bce(preds, b['label'])
        return loss, {'preds': preds, 'per_example_loss': pel}

      opt = multi_optimizer(optax.adagrad(table_lr),
                            optax.adam(dense_lr))(params)
      tr = hb.Trainer(loss_fn, params, opt, model_dir=None)
    else:

      def model_loss(dense_params, emb_f, dense_f, b):
        preds = stacked_dcn_v2_apply(dense_params, emb_f + dense_f)
        loss, pel = bce(preds, b['label'])
        return loss, {'preds': preds, 'per_example_loss': pel}

      tr = hb.estimator.SparseTrainer(
          fx, model_loss, net0, tables=fx.init(k_tab),
          dense_optimizer=optax.adam(dense_lr), table_lr=table_lr,
          model_dir=None)

    for epoch in range(epochs):
      m = tr.train(batches(train_path, True, seed * 100 + epoch),
                   max_steps=steps)
      res = tr.evaluate(batches(eval_path, False, 0))
      curve.append({'epoch': epoch, 'train_loss': float(m['loss']),
                    'eval_auc': float(res['auc']),
                    'eval_loss': float(res['loss'])})
  return curve[-1]['eval_auc'], curve


FAST_OPTIONS = {
    # The full fast path at DEFAULT ratios, plus the bf16 wire for
    # embeddings and gradients.
    'comm_wire_dtype': 'bfloat16',
    'comm_gradient_wire_dtype': 'bfloat16',
}

OVERFLOW_OPTIONS = {
    **FAST_OPTIONS,
    # Capacities far below the realized occupancies: the exact
    # lax.cond fallbacks must carry the step (verified out-of-band by
    # _overflow_expected).
    'emb_lookup_bucket_ratio': 0.25,
    'emb_update_bucket_ratio': 0.25,
    'emb_unique_ratio': 0.05,
}


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--rows', type=int, default=1 << 20)
  p.add_argument('--eval-rows', type=int, default=1 << 17)
  p.add_argument('--tables', type=int, default=26)
  p.add_argument('--vocab', type=int, default=100_000)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--batch', type=int, default=8192)
  p.add_argument('--epochs', type=int, default=2)
  p.add_argument('--steps', type=int, default=None,
                 help='cap steps per epoch (default: full pass)')
  p.add_argument('--exact-seeds', type=int, nargs='*', default=[0, 1])
  p.add_argument('--table-lr', type=float, default=0.05)
  p.add_argument('--dense-lr', type=float, default=1e-3)
  p.add_argument('--cache', default='/tmp/auc_parity')
  p.add_argument('--cpu', type=int, default=0)
  p.add_argument('--skip-overflow', action='store_true')
  p.add_argument('--json', action='store_true')
  args = p.parse_args()

  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import hybridbackend_tpu as hb

  os.makedirs(args.cache, exist_ok=True)
  sig = f'{args.rows}x{args.tables}v{args.vocab}'
  train_path = os.path.join(args.cache, f'train_{sig}.parquet')
  eval_path = os.path.join(args.cache, f'eval_{sig}.parquet')
  if not os.path.exists(train_path):
    synthesize(train_path, args.rows, args.tables, args.vocab, seed=11)
  if not os.path.exists(eval_path):
    synthesize(eval_path, args.eval_rows, args.tables, args.vocab,
               seed=999)

  kw = dict(tables=args.tables, vocab=args.vocab, dim=args.dim,
            batch=args.batch, epochs=args.epochs, steps=args.steps,
            table_lr=args.table_lr, dense_lr=args.dense_lr)
  out = {'config': {**kw, 'rows': args.rows}}
  results = {}

  exact_aucs = []
  for seed in args.exact_seeds:
    t0 = time.time()
    auc, curve = run_variant('exact', train_path, eval_path, seed=seed,
                             options={}, **kw)
    exact_aucs.append(auc)
    results[f'exact_seed{seed}'] = {'auc': auc, 'curve': curve,
                                    'secs': round(time.time() - t0, 1)}
    print(f'exact seed{seed}: auc={auc:.4f}', file=_sys.stderr)

  t0 = time.time()
  auc_fast, curve = run_variant('fast', train_path, eval_path,
                                seed=args.exact_seeds[0],
                                options=FAST_OPTIONS, **kw)
  results['fast'] = {'auc': auc_fast, 'curve': curve,
                     'secs': round(time.time() - t0, 1)}
  print(f'fast: auc={auc_fast:.4f}', file=_sys.stderr)

  world = hb.Context.get().world_size
  if not args.skip_overflow:
    fired, caps = _overflow_expected(
        train_path, args.tables, args.batch, world,
        OVERFLOW_OPTIONS['emb_lookup_bucket_ratio'],
        OVERFLOW_OPTIONS['emb_update_bucket_ratio'])
    t0 = time.time()
    auc_ovf, curve = run_variant('fast_overflow', train_path, eval_path,
                                 seed=args.exact_seeds[0],
                                 options=OVERFLOW_OPTIONS, **kw)
    results['fast_overflow'] = {'auc': auc_ovf, 'curve': curve,
                                'overflow_must_fire': bool(fired),
                                'caps': caps,
                                'secs': round(time.time() - t0, 1)}
    print(f'fast_overflow: auc={auc_ovf:.4f} (fallbacks must fire: '
          f'{fired})', file=_sys.stderr)

  spread = (max(exact_aucs) - min(exact_aucs)) if len(exact_aucs) > 1 \
      else 0.0
  band = max(spread * 1.5, 0.006)
  mean_exact = sum(exact_aucs) / len(exact_aucs)
  out.update(results=results, exact_mean_auc=round(mean_exact, 4),
             exact_spread=round(spread, 4), parity_band=round(band, 4))
  verdicts = {}
  for key in ('fast', 'fast_overflow'):
    if key in results:
      verdicts[key] = abs(results[key]['auc'] - mean_exact) <= band
  out['parity_ok'] = verdicts
  print(json.dumps(out if args.json else
                   {k: out[k] for k in ('exact_mean_auc', 'exact_spread',
                                        'parity_band', 'parity_ok')}))
  if not all(verdicts.values()):
    _sys.exit(1)


if __name__ == '__main__':
  main()
