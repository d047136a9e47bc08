"""Training-step benchmark (flagship wide&deep ranking model).

Times the full hybrid-parallel train step — embedding lookup, DCNv2 or
DLRM tower, dense optimizer and table update — on the GPU (or, with
``--cpu N``, on N virtual CPU devices, for rehearsal only). Batches are
device-resident, made from ``--seed`` with the flagship's Zipf ids
(``hybridbackend_tpu/utils/flagship.py``). Each timed step is measured
on the host clock around a call that ends in ``block_until_ready``,
after ``WARMUP`` steps; compilations inside the timed window are
counted and must be zero. The table layout follows the ``emb_lane_pack``
option (``HB_EMB_LANE_PACK=on`` packs); the result records it.

``--trace DIR`` then traces a few steps with ``jax.profiler`` and
reports device time per named scope of the sparse step (lookup, tower,
dense_update, table_update) and the device's idle share. It turns off
XLA's CUDA command buffers for the whole run, because a command buffer
shows in the trace as one event and hides the ops inside it; the run's
``xla_flags`` say so.

Reference analogue: the reference publishes training throughput only in
the PICASSO paper; its repo harnesses time collectives and data loading
(the reference's ``hybridbackend/tensorflow/benchmarks/``).

Usage:
  python benchmarks/train_benchmark.py [--sparse] [--batch 8192]
      [--dim 16] [--tables 26] [--vocab 100000] [--steps 20]
      [--model dcnv2] [--trace DIR] [--cpu N] [--json]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import json
import time

SCOPES = ('lookup', 'tower', 'dense_update', 'table_update')
WARMUP = 3


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--batch', type=int, default=8192)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--tables', type=int, default=26)
  p.add_argument('--dense-features', type=int, default=13)
  p.add_argument('--vocab', type=int, default=100_000)
  p.add_argument('--steps', type=int, default=20)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--model', default='dcnv2', choices=['dcnv2', 'dlrm'])
  p.add_argument('--sparse', action='store_true',
                 help='stacked tables + row-sparse Adagrad '
                      '(no dense [V, D] gradients)')
  p.add_argument('--bf16', action='store_true',
                 help='bfloat16 matmul compute (params stay fp32)')
  p.add_argument('--no-dedup', action='store_true',
                 help='sparse mode: skip duplicate-id combining '
                      '(TF SparseApplyAdagrad semantics, no sort)')
  p.add_argument('--interleave', type=int, default=0, metavar='K',
                 help='sparse mode: PICASSO interleaving over K '
                      'micro-batches')
  p.add_argument('--table-dtype', default='float32',
                 choices=['float32', 'bfloat16'],
                 help='embedding table storage dtype')
  p.add_argument('--trace', default='', metavar='DIR',
                 help='sparse mode: trace a few steps into DIR and '
                      'report device time per named scope')
  p.add_argument('--cpu', type=int, default=0)
  p.add_argument('--json', action='store_true')
  args = p.parse_args()

  if args.trace:
    _os.environ['XLA_FLAGS'] = (_os.environ.get('XLA_FLAGS', '') +
                                ' --xla_gpu_enable_command_buffer=').strip()
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
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor, extract_features,
      init_tables, dlrm_apply, dlrm_init, stacked_dcn_v2_apply,
      stacked_dcn_v2_init)
  from hybridbackend_tpu.training import (
      SparseTrainState, TrainState, make_sparse_train_step,
      make_train_step, multi_optimizer)
  from hybridbackend_tpu.utils.flagship import FlagshipConfig, make_batches

  lowerings = [0]
  jax.monitoring.register_event_duration_secs_listener(
      lambda e, d, **_: lowerings.__setitem__(0, lowerings[0] + 1)
      if e == '/jax/core/compile/jaxpr_to_mlir_module_duration' else None)

  if args.bf16:
    hb.OPTIONS['compute_dtype'] = 'bfloat16'
  ctx = hb.Context.get()
  tdt = jnp.bfloat16 if args.table_dtype == 'bfloat16' else jnp.float32
  fcfg = FlagshipConfig(tables=args.tables, vocab=args.vocab, dim=args.dim,
                        dense=args.dense_features, batch=args.batch)
  specs = [EmbeddingSpec(TableConfig(name, args.vocab, args.dim,
                                     dtype=tdt))
           for name in fcfg.table_names]
  dense_names = fcfg.dense_names
  k_tab, k_net = jax.random.split(jax.random.PRNGKey(args.seed))
  if args.model == 'dcnv2':
    net = stacked_dcn_v2_init(
        k_net, [args.dim] * args.tables + [1] * args.dense_features,
        [1024, 512, 256, 1])
    apply_fn = stacked_dcn_v2_apply
  else:
    net = dlrm_init(k_net, args.dense_features, args.tables,
                    [512, 256], args.dim, [1024, 512, 1])
    apply_fn = dlrm_apply

  def preds_from(net_params, emb, dense):
    if args.model == 'dcnv2':
      return apply_fn(net_params, emb + dense)
    return apply_fn(net_params, dense, emb)

  def bce(preds, y):
    preds = jnp.clip(preds, 1e-6, 1 - 1e-6)
    return -jnp.mean(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))

  if args.sparse:
    fx = StackedFeatureExtractor(specs, dense_columns=dense_names,
                                 ctx=ctx)
    tables = fx.init(k_tab)

    def model_loss(dense_params, emb_f, dense_f, batch):
      return bce(preds_from(dense_params, emb_f, dense_f),
                 batch['label']), {}

    state = SparseTrainState.create(net, tables, optax.adam(1e-3),
                                    adagrad_init=0.1, ctx=ctx)
    if args.interleave >= 1:
      from hybridbackend_tpu.pipeline import make_interleaved_train_step
      if args.no_dedup:
        raise SystemExit('--no-dedup is not supported with --interleave')
      step = make_interleaved_train_step(
          fx, model_loss, optax.adam(1e-3), args.interleave,
          table_lr=0.05, ctx=ctx)
    else:
      step = make_sparse_train_step(fx, model_loss, optax.adam(1e-3),
                                    table_lr=0.05,
                                    table_dedup=not args.no_dedup,
                                    ctx=ctx)
  else:
    tables = init_tables(specs, k_tab, ctx)
    params = {'tables': tables, 'net': net}

    def loss_fn(params, batch):
      emb, dense = extract_features(params['tables'], batch, specs,
                                    dense_names, ctx=ctx)
      return bce(preds_from(params['net'], emb, dense),
                 batch['label']), {}

    opt = multi_optimizer(optax.adagrad(0.05), optax.adam(1e-3))(params)
    state = TrainState.create(params, opt, ctx)
    step = make_train_step(loss_fn, opt, ctx)

  batches = [{k: jax.device_put(v, ctx.batch_sharding)
              for k, v in b.items()}
             for b in make_batches(fcfg, 4, args.seed)]

  t0 = time.perf_counter()
  for i in range(WARMUP):
    state, m = step(state, batches[i % len(batches)])
    jax.block_until_ready(m['loss'])
  warm_s = time.perf_counter() - t0
  before = lowerings[0]
  times = []
  for i in range(args.steps):
    t0 = time.perf_counter()
    state, m = step(state, batches[i % len(batches)])
    jax.block_until_ready(m['loss'])
    times.append(time.perf_counter() - t0)
  compiles = lowerings[0] - before
  if compiles:
    raise SystemExit(f'{compiles} compilations inside the timed window')
  ms = np.asarray(times) * 1e3
  med = float(np.median(ms))

  dev = jax.devices()[0]
  result = {
      'metric': 'train_examples_per_sec',
      'value': round(args.batch / med * 1e3, 1),
      'unit': 'examples/s',
      'ms_per_step': round(med, 3),
      'ms_p10_p90': [round(float(np.percentile(ms, 10)), 3),
                     round(float(np.percentile(ms, 90)), 3)],
      'model': args.model,
      'sparse': args.sparse,
      'interleave': args.interleave,
      'bf16': args.bf16,
      'lane_pack': hb.OPTIONS['emb_lane_pack'],
      'table_shapes': {n: list(t.shape) for n, t in state.tables.items()}
      if args.sparse else None,
      'batch': args.batch,
      'tables': args.tables,
      'dim': args.dim,
      'platform': dev.platform,
      'device_kind': dev.device_kind,
      'device_count': len(jax.devices()),
      'warmup_s': round(warm_s, 2),
      'xla_flags': _os.environ.get('XLA_FLAGS', ''),
      'final_loss': round(float(m['loss']), 4),
  }

  if args.sparse and args.trace:
    result['trace_ms_per_step'] = _trace(step, state, batches, args.trace)

  if args.json:
    print(json.dumps(result))
  else:
    for k, v in result.items():
      print(f'{k:>22}: {v}')


def _trace(step, state, batches, trace_dir, n=5):
  """Device ms per step, per named scope, over ``n`` traced steps."""
  import jax
  from hybridbackend_tpu.utils.profiler import device_time_by_scope
  hlo = step.lower(state, batches[0]).compile().as_text()
  with jax.profiler.trace(trace_dir):
    for i in range(n):
      state, m = step(state, batches[i % len(batches)])
      jax.block_until_ready(m['loss'])
  from hybridbackend_tpu.utils.profiler import op_names
  t = device_time_by_scope(trace_dir, hlo, SCOPES)
  ops = t.pop('ops')
  out = {k: round(v / n / 1e6, 4) for k, v in t.items() if k != 'events'}
  out['idle_share'] = round(1 - t['busy'] / t['window'], 4) \
      if t['window'] else None
  out['events'] = int(t['events'])
  names = op_names(hlo)
  out['top_ops'] = [[op, names.get(op, '?')[-60:], round(v / n / 1e6, 4)]
                    for op, v in sorted(ops.items(), key=lambda kv: -kv[1])
                    [:15]]
  return out


if __name__ == '__main__':
  main()
