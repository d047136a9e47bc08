"""Taobao DIN training: ragged user-behavior sequences.

A JAX port of the reference tutorial
(``/root/reference/docs/tutorial/ranking/taobao/train_keras_din.py``):
candidate-item embedding queries an attention pool over the user's
variable-length click history (ragged Parquet list column → padded+mask),
plus user-profile features, into a DNN.

  python examples/taobao/train_din.py --synthesize --steps 200 --cpu 8
  python examples/taobao/train_din.py --synthesize --sparse   # row-sparse
  python examples/taobao/train_din.py --synthesize --sessions # nested
                                     # ragged list<list> history through
                                     # the session-grouped DIN
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))


import argparse
import os

import numpy as np

ITEM_VOCAB = 50_000
USER_VOCAB = 20_000
CATE_VOCAB = 1_000


def synthesize(path: str, rows: int, sessions: bool = False) -> None:
  import pandas as pd
  rng = np.random.RandomState(0)
  # Users have a preferred category; they click items of that category
  # (signal: candidate in-category + history overlap → click).
  # Draw from a compact active-id subset so the sample is learnable at
  # small row counts (tables keep their full production vocab sizes).
  active_items = min(ITEM_VOCAB, max(2000, rows // 20))
  user = rng.randint(0, min(USER_VOCAB, rows // 10 + 100), rows)
  pref = user % CATE_VOCAB
  # Half the impressions are in-category candidates so the preference
  # signal is present at a learnable rate.
  in_cate = rng.rand(rows) < 0.5
  rand_item = rng.randint(0, active_items, rows)
  cate_item = pref + CATE_VOCAB * rng.randint(
      0, max(1, active_items // CATE_VOCAB), rows)
  item = np.where(in_cate, cate_item, rand_item)
  item_cate = item % CATE_VOCAB
  hists = []
  for i in range(rows):
    n = rng.randint(1, 20)
    hist_items = (pref[i] + CATE_VOCAB * rng.randint(
        0, active_items // CATE_VOCAB, n)).astype(np.int64).tolist()
    if sessions:
      # Session-grouped history (nested ragged, reference
      # dataframe.py:282-396): split the click stream into 1-4
      # sessions of consecutive events.
      ns = rng.randint(1, 5)
      cuts = sorted(rng.randint(0, n + 1, ns - 1).tolist())
      bounds = [0] + cuts + [n]
      hist_items = [hist_items[a:b] for a, b in zip(bounds, bounds[1:])]
    hists.append(hist_items)
  match = (item_cate == pref).astype(np.float32)
  p = 0.1 + 0.8 * match
  label = (rng.rand(rows) < p).astype(np.float32)
  pd.DataFrame({
      'user': user.astype(np.int64), 'item': item.astype(np.int64),
      'hist': hists, 'label': label,
  }).to_parquet(path, row_group_size=4096)


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--data', default='/tmp/taobao_sample.parquet')
  p.add_argument('--synthesize', action='store_true')
  p.add_argument('--rows', type=int, default=50_000)
  p.add_argument('--batch-size', type=int, default=512)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--max-hist', type=int, default=32)
  p.add_argument('--steps', type=int, default=None)
  p.add_argument('--epochs', type=int, default=1)
  p.add_argument('--model-dir', default='')
  p.add_argument('--sparse', action='store_true',
                 help='row-sparse table updates; uses SparseTrainer '
                      'raw mode')
  p.add_argument('--sessions', action='store_true',
                 help='session-grouped history: a nested-ragged '
                      'list<list<int64>> Parquet column padded to '
                      '[B, S, L] + 2-level mask, consumed by '
                      'din_session_apply')
  p.add_argument('--max-sessions', type=int, default=4)
  p.add_argument('--cpu', type=int, default=0)
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
  from hybridbackend_tpu.data import Field
  from hybridbackend_tpu.embedding import TableConfig, lookup
  from hybridbackend_tpu.models import (
      EmbeddingSpec, din_apply, din_init, din_session_apply,
      din_session_init, extract_features, init_tables)
  from hybridbackend_tpu.training import LoggingHook, multi_optimizer

  if args.sessions and args.data == '/tmp/taobao_sample.parquet':
    args.data = '/tmp/taobao_sessions.parquet'
  if args.synthesize or not os.path.exists(args.data):
    print(f'synthesizing {args.rows} rows → {args.data}')
    synthesize(args.data, args.rows, sessions=args.sessions)

  item_cfg = TableConfig('item', ITEM_VOCAB, args.dim)
  user_cfg = TableConfig('user', USER_VOCAB, args.dim)
  key = jax.random.PRNGKey(0)
  k_tab, k_net = jax.random.split(key)
  net = (din_session_init if args.sessions else din_init)(
      k_net, args.dim, num_profile_features=1, num_dense=0)

  def din_loss(net_params, query, keys, profile, batch):
    preds = din_apply(net_params, query, keys, batch['hist_mask'],
                      [profile])
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    y = batch['label']
    pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
    return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}

  if args.sparse:
    # Candidate + history resolved in ONE fused exchange ('cand_hist'
    # column, [B, 1+L] — or [B, 1+S*L] for --sessions, the rank-2
    # padded history flattened with mask-derived -1 invalids); raw mode
    # hands attention the uncombined sequence (session structure is
    # restored in the model fn). Tables update on touched rows only.
    from hybridbackend_tpu.models import StackedFeatureExtractor
    fx = StackedFeatureExtractor(
        [EmbeddingSpec(item_cfg, column='cand_hist'),
         EmbeddingSpec(user_cfg)])

    def raw_loss(net_params, members, batch):
      emb = members['item']                               # [B, 1+L, D]
      if args.sessions:
        mask = batch['hist_mask']                         # [B, S, L]
        keys = emb[:, 1:].reshape(
            emb.shape[0], mask.shape[1], mask.shape[2], emb.shape[-1])
        preds = din_session_apply(net_params, emb[:, 0], keys, mask,
                                  [members['user']])
        preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
        y = batch['label']
        pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
        return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}
      return din_loss(net_params, emb[:, 0], emb[:, 1:],
                      members['user'], batch)

    trainer = hb.SparseTrainer(fx, None, net, rng=k_tab,
                               raw_model_loss=raw_loss, table_lr=0.1,
                               model_dir=args.model_dir or None,
                               group_key='user')
  else:
    specs = [EmbeddingSpec(item_cfg), EmbeddingSpec(user_cfg)]
    params = {
        'tables': init_tables(specs, k_tab),
        'net': net,
    }

    def loss_fn(params, batch):
      tables = params['tables']
      query = lookup(tables['item'], batch['item'], item_cfg)    # [B,D]
      # --sessions: hist is [B, S, L] (+mask) from the rank-2 ragged
      # column; lookup broadcasts over the extra axis and
      # din_session_apply pools events -> sessions -> history.
      keys = lookup(tables['item'], batch['hist'], item_cfg)
      profile = lookup(tables['user'], batch['user'], user_cfg)
      if args.sessions:
        preds = din_session_apply(params['net'], query, keys,
                                  batch['hist_mask'], [profile])
        preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
        y = batch['label']
        pel = -(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
        return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}
      return din_loss(params['net'], query, keys, profile, batch)

    opt = multi_optimizer(optax.adagrad(0.1), optax.adam(1e-3))(params)
    trainer = hb.Trainer(loss_fn, params, opt,
                         model_dir=args.model_dir or None,
                         group_key='user')

  ctx = hb.Context.get()
  fields = [Field('hist', ragged_rank=2,
                  max_len=(args.max_sessions, args.max_hist))
            if args.sessions else
            Field('hist', ragged_rank=1, max_len=args.max_hist)]

  def add_cand_hist(b):
    if args.sparse:
      b = dict(b)
      hist = np.asarray(b['hist'])
      if args.sessions:
        # [B, S, L] -> [B, S*L] with padding ids forced to -1: the
        # sparse path's validity contract turns them into zero vectors
        # and the update kernel never touches a table row for them.
        mask = np.asarray(b['hist_mask']).reshape(hist.shape[0], -1)
        hist = np.where(mask.astype(bool),
                        hist.reshape(hist.shape[0], -1), -1)
      b['cand_hist'] = np.concatenate(
          [np.asarray(b['item'])[:, None], hist], axis=1)
    return b

  def batches(shuffle):
    ds = hb.data.Dataset.from_parquet(
        args.data, batch_size=args.batch_size, drop_remainder=True,
        shuffle=shuffle, partition_index=ctx.rank,
        partition_count=ctx.num_processes)
    return (add_cand_hist(hb.data.parse(b, fields)) for b in ds)

  hooks = [LoggingHook(every_n_steps=25, log=print)]
  for epoch in range(args.epochs):
    trainer.train(batches(True), max_steps=args.steps, hooks=hooks)
    print(f'epoch {epoch}:', trainer.evaluate(batches(False)))


if __name__ == '__main__':
  main()
