"""DIN (ragged behavior-sequence) training benchmark.

BASELINE config #5: sequence-feature ranking with attention pooling of
a variable-length user-behavior history (padded + masked on device).
Measures the full train step — item-table lookup for candidate AND
history (one stacked exchange), attention pooling, DNN, multi-optimizer
update — with ``--inner-steps`` steps inside one jitted ``lax.scan``
(one dispatch and one readback per window).

Usage: python benchmarks/din_benchmark.py [--batch 2048] [--dim 32]
       [--hist 64] [--vocab 1000000] [--inner-steps 20] [--cpu N]
       [--json]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--batch', type=int, default=2048)
  p.add_argument('--dim', type=int, default=32)
  p.add_argument('--hist', type=int, default=64)
  p.add_argument('--vocab', type=int, default=1_000_000)
  p.add_argument('--inner-steps', type=int, default=20)
  p.add_argument('--repeats', type=int, default=3)
  p.add_argument('--sparse', action='store_true',
                 help='row-sparse table updates via '
                      'make_sparse_train_step raw mode')
  p.add_argument('--sessions', type=int, default=0, metavar='S',
                 help='session-grouped history: [B, S, hist/S] + '
                      '2-level mask through din_session_apply (the '
                      'rank-2 nested-ragged device layout); composes '
                      'with --sparse (flattened ids + mask-derived -1 '
                      'invalids ride the row-sparse fast path)')
  p.add_argument('--cpu', type=int, default=0)
  p.add_argument('--json', action='store_true')
  args = p.parse_args()

  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import jax
  import jax.numpy as jnp
  import numpy as np
  import optax
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.embedding import TableConfig, create_table
  from hybridbackend_tpu.embedding.lookup import lookup
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor, din_apply, din_init,
      din_session_apply, din_session_init)
  from hybridbackend_tpu.training import (
      SparseTrainState, TrainState, make_sparse_train_step,
      make_train_step, multi_optimizer)

  ctx = hb.Context.get()
  item_cfg = TableConfig('item', args.vocab, args.dim)
  user_cfg = TableConfig('user', args.vocab // 10, args.dim)
  key = jax.random.PRNGKey(0)
  k_i, k_u, k_net = jax.random.split(key, 3)
  S = args.sessions
  if S:
    if args.hist % S:
      raise SystemExit('--hist must divide by --sessions')
    L = args.hist // S
    net = din_session_init(k_net, args.dim, num_profile_features=1,
                           num_dense=2)
  else:
    net = din_init(k_net, args.dim, num_profile_features=1, num_dense=2)

  def din_loss(net_params, query, keys, user, batch):
    if S:
      keys = keys.reshape(keys.shape[0], S, L, keys.shape[-1])
      preds = din_session_apply(net_params, query, keys,
                                batch['hist_mask'], [user],
                                [batch['d0'], batch['d1']])
    else:
      preds = din_apply(net_params, query, keys, batch['hist_mask'],
                        [user], [batch['d0'], batch['d1']])
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    y = batch['label']
    loss = -jnp.mean(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return loss, {}

  if args.sparse:
    # Row-sparse path: 'cand_hist' carries [B, 1+L] ids; raw mode hands
    # the model the UNCOMBINED [B, 1+L, D] sequence for attention.
    fx = StackedFeatureExtractor(
        [EmbeddingSpec(item_cfg, column='cand_hist'),
         EmbeddingSpec(user_cfg)], ctx=ctx)
    tables = fx.init(k_i)

    def raw_loss(net_params, members, batch):
      emb = members['item']                                 # [B, 1+L, D]
      return din_loss(net_params, emb[:, 0], emb[:, 1:],
                      members['user'], batch)

    state = SparseTrainState.create(net, tables, optax.adam(1e-3),
                                    adagrad_init=0.1, ctx=ctx)
    step = make_sparse_train_step(fx, None, optax.adam(1e-3),
                                  table_lr=0.05, ctx=ctx,
                                  raw_model_loss=raw_loss,
                                  donate_state=False)
  else:
    params = {
        'tables': {'item': create_table(item_cfg, k_i, ctx),
                   'user': create_table(user_cfg, k_u, ctx)},
        'net': net,
    }

    def loss_fn(params, batch):
      t = params['tables']
      # Candidate + history share the item table: ONE fused exchange.
      all_ids = jnp.concatenate([batch['item'][:, None], batch['hist']],
                                axis=1)                     # [B, 1+L]
      emb = lookup(t['item'], all_ids, item_cfg, ctx=ctx)   # [B, 1+L, D]
      user = lookup(t['user'], batch['user'], user_cfg, ctx=ctx)
      return din_loss(params['net'], emb[:, 0], emb[:, 1:], user, batch)

    opt = multi_optimizer(optax.adagrad(0.05), optax.adam(1e-3))(params)
    state = TrainState.create(params, opt, ctx)
    step = make_train_step(loss_fn, opt, ctx)

  rng = np.random.RandomState(0)
  if S:
    # Per-session lengths -> a [B, S, L] 2-level mask (the to_padded
    # device layout of a rank-2 ragged column).
    slen = rng.randint(0, L + 1, (args.batch, S))
    slen[:, 0] = np.maximum(slen[:, 0], 1)
    mask = (np.arange(L)[None, None, :] < slen[:, :, None]
            ).reshape(args.batch, S, L)
  else:
    lengths = rng.randint(1, args.hist + 1, args.batch)
    mask = (np.arange(args.hist)[None, :] < lengths[:, None])
  base = {
      'item': jnp.asarray(rng.randint(0, args.vocab, args.batch),
                          jnp.int32),
      'hist': jnp.asarray(
          rng.randint(0, args.vocab, (args.batch, args.hist)), jnp.int32),
      'hist_mask': jnp.asarray(mask),
      'user': jnp.asarray(rng.randint(0, args.vocab // 10, args.batch),
                          jnp.int32),
      'd0': jnp.asarray(rng.rand(args.batch, 1), jnp.float32),
      'd1': jnp.asarray(rng.rand(args.batch, 1), jnp.float32),
      'label': jnp.asarray(rng.randint(0, 2, args.batch), jnp.float32),
  }
  if S:
    base['hist_mask'] = jnp.asarray(mask)                   # [B, S, L]
    if args.sparse:
      # Mask-derived -1 invalids: padding ids must not touch rows.
      flat = jnp.where(mask.reshape(args.batch, -1),
                       base['hist'], -1)
      base['cand_hist'] = jnp.concatenate(
          [base['item'][:, None], flat], axis=1)            # [B, 1+S*L]
  else:
    base['cand_hist'] = jnp.concatenate(
        [base['item'][:, None], base['hist']], axis=1)      # [B, 1+L]
  base = {k: jax.device_put(v, ctx.batch_sharding) for k, v in base.items()}

  def multi_step(state, _):
    def body(carry, i):
      st = carry
      batch = dict(base)
      batch['item'] = (base['item'] + i) % args.vocab
      batch['hist'] = (base['hist'] + i) % args.vocab
      if 'cand_hist' in base:
        # Valid lanes shift with i; -1 invalids (sessions+sparse) stay
        # invalid — jnp.where keeps the mask-derived holes.
        ch = base['cand_hist']
        batch['cand_hist'] = jnp.where(ch >= 0, (ch + i) % args.vocab,
                                       ch)
      st, metrics = step(st, batch)
      return st, metrics['loss']
    return jax.lax.scan(body, state, jnp.arange(args.inner_steps))

  multi = jax.jit(multi_step)
  t0 = time.perf_counter()
  state, losses = multi(state, 0)
  first = float(losses[-1])
  compile_s = time.perf_counter() - t0
  times = []
  for _ in range(args.repeats):
    t0 = time.perf_counter()
    state, losses = multi(state, 0)
    _ = float(losses[-1])
    times.append(time.perf_counter() - t0)
  best = min(times)
  result = {
      'metric': 'din_examples_per_sec',
      'value': round(args.batch * args.inner_steps / best, 1),
      'unit': 'examples/s',
      'ms_per_step': round(1000 * best / args.inner_steps, 3),
      'batch': args.batch, 'hist': args.hist, 'dim': args.dim,
      'vocab': args.vocab, 'devices': ctx.world_size,
      'sparse': args.sparse, 'sessions': S,
      'platform': jax.devices()[0].platform,
      'device_kind': jax.devices()[0].device_kind,
      'device_count': len(jax.devices()),
      'compile_s': round(compile_s, 1), 'final_loss': round(first, 4),
  }
  if args.json:
    print(json.dumps(result))
  else:
    for k, v in result.items():
      print(f'{k:>18}: {v}')


if __name__ == '__main__':
  main()
