"""Dense-gradient wire compression (round-3 order #5).

The reference casts gradient collectives on the wire generally
(``/root/reference/hybridbackend/tensorflow/distribute/collective.py:291-296``
+ ``common/cast.cu.cc:37-488``). Here ``comm_gradient_wire_dtype``
reaches the DENSE parameter gradients too: ``make_train_step`` builds an
explicit shard_map reduction whose psum summand is cast to the wire
dtype (GSPMD's implicit allreduce is always accumulator-precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import hybridbackend_tpu as hb
from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.training.train import TrainState, make_train_step


def _toy_batch(rng, n=64):
  x = rng.rand(n, 8).astype(np.float32)
  y = (x.sum(1) > 4.0).astype(np.float32)
  return {'x': x, 'label': y}


def _loss_fn(params, batch):
  h = jnp.tanh(batch['x'] @ params['w1'])
  logits = (h @ params['w2'])[:, 0]
  preds = jax.nn.sigmoid(logits)
  p = jnp.clip(preds, 1e-6, 1 - 1e-6)
  y = batch['label']
  pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
  return jnp.mean(pel), {'preds': preds}


def _params(seed=0):
  rng = np.random.RandomState(seed)
  return {'w1': jnp.asarray(rng.randn(8, 16).astype(np.float32) * 0.3),
          'w2': jnp.asarray(rng.randn(16, 1).astype(np.float32) * 0.3)}


def _put(batch, ctx):
  return {k: jax.device_put(v, ctx.batch_sharding if v.ndim == 1
                            else ctx.sharding(ctx.data_axes, None))
          for k, v in batch.items()}


def test_hlo_bf16_allreduce():
  """With the option set, the program's cross-replica gradient psum
  operates on bf16 operands; without it, no bf16 reduction exists.

  Asserted on the LOWERED (pre-backend-optimization) module: the CPU
  backend legalizes bf16 collectives by upcasting around them, while
  other backends may execute them natively — the portable property is what the program
  requests on the wire."""
  ctx = Context.get()
  opt = optax.sgd(0.1)

  def lower(wire):
    with hb.scope(comm_gradient_wire_dtype=wire):
      state = TrainState.create(_params(), opt, ctx)
      step = make_train_step(_loss_fn, opt, ctx,
                             params_template=state.params)
      batch = _put(_toy_batch(np.random.RandomState(0)), ctx)
      return step.lower(state, batch).as_text()

  def bf16_all_reduce(hlo):
    # StableHLO puts the op's type signature lines after the op line;
    # scan a small window (the reduction region's scalar add carries
    # `tensor<bf16>` and the signature `tensor<NxMxbf16>`).
    lines = hlo.splitlines()
    for i, l in enumerate(lines):
      if 'all_reduce' in l:
        if any('bf16' in w for w in lines[i:i + 8]):
          return True
    return False

  hlo_c = lower('bfloat16')
  assert 'all_reduce' in hlo_c
  assert bf16_all_reduce(hlo_c)

  # f32: the step stays on the GSPMD path (no explicit shard_map
  # all_reduce in the lowered module — the partitioner inserts it at
  # compile time) and nothing rides bf16.
  hlo_f = lower('float32')
  assert 'bf16' not in hlo_f


def test_templateless_step_still_compresses():
  """Round-4 order #5: ``make_train_step`` WITHOUT ``params_template``
  must still emit the bf16 all-reduce (the template is derived from the
  first concrete state) and report ``wire_grad=1.0``."""
  ctx = Context.get()
  opt = optax.sgd(0.1)
  with hb.scope(comm_gradient_wire_dtype='bfloat16'):
    state = TrainState.create(_params(), opt, ctx)
    step = make_train_step(_loss_fn, opt, ctx, donate_state=False)
    batch = _put(_toy_batch(np.random.RandomState(0)), ctx)
    hlo = step.lower(state, batch).as_text()
    assert 'all_reduce' in hlo and 'bf16' in hlo
    state2, m = step(state, batch)
    assert float(m['wire_grad']) == 1.0
    assert np.isfinite(float(m['loss']))


def test_tracer_first_call_does_not_latch_fallback():
  """A first call under a trace can't read shardings and builds the
  GSPMD fallback — but must NOT cache it: the next non-traced call
  rebuilds with the real template and wire compression engages
  (round-4 weak #5)."""
  ctx = Context.get()
  opt = optax.sgd(0.1)
  with hb.scope(comm_gradient_wire_dtype='bfloat16'):
    state = TrainState.create(_params(), opt, ctx)
    step = make_train_step(_loss_fn, opt, ctx, donate_state=False)
    batch = _put(_toy_batch(np.random.RandomState(0)), ctx)

    # First use happens INSIDE another trace: params are tracers.
    @jax.jit
    def outer(s, b):
      _, m = step(s, b)
      return m['wire_grad']

    assert float(outer(state, batch)) == 0.0   # tracer build: fallback
    # First non-traced call must rebuild and compress.
    _, m = step(state, batch)
    assert float(m['wire_grad']) == 1.0
    hlo = step.lower(state, batch).as_text()
    assert 'all_reduce' in hlo and 'bf16' in hlo


def test_wire_grad_metric_reports_fallback():
  """With a mesh-sharded params leaf the step falls back to the GSPMD
  f32 reduction — and says so via ``metrics['wire_grad'] == 0.0``
  instead of only a log line (structured signal, round-4 order #5)."""
  ctx = Context.get()
  opt = optax.sgd(0.1)
  table = jax.device_put(
      jnp.ones((64, 4)), ctx.sharding(ctx.data_axes, None))

  def loss_fn(params, batch):
    emb = jnp.take(params['table'], batch['ids'], axis=0)
    preds = jax.nn.sigmoid(emb.sum((1, 2)) + (batch['x'] @ params['w'])[:, 0])
    return jnp.mean((preds - batch['label']) ** 2), {'preds': preds}

  params = {'table': table, 'w': jnp.zeros((8, 1), jnp.float32)}
  with hb.scope(comm_gradient_wire_dtype='bfloat16'):
    state = TrainState.create(params, opt, ctx)
    step = make_train_step(loss_fn, opt, ctx, donate_state=False)
    rng = np.random.RandomState(2)
    b = _toy_batch(rng)
    b['ids'] = rng.randint(0, 64, (64, 2)).astype(np.int32)
    _, m = step(state, _put(b, ctx))
  assert float(m['wire_grad']) == 0.0


def test_convergence_parity():
  """bf16-on-the-wire training tracks f32 training closely on the toy
  model (convergence parity, not bit equality)."""
  ctx = Context.get()
  opt = optax.sgd(0.5)
  rng = np.random.RandomState(1)
  batches = [_toy_batch(rng) for _ in range(30)]

  def run(wire):
    with hb.scope(comm_gradient_wire_dtype=wire):
      state = TrainState.create(_params(3), opt, ctx)
      step = make_train_step(_loss_fn, opt, ctx,
                             params_template=state.params)
      losses = []
      for b in batches:
        state, m = step(state, _put(b, ctx))
        losses.append(float(m['loss']))
      return losses

  f32 = run('float32')
  bf16 = run('bfloat16')
  assert f32[-1] < f32[0]
  assert bf16[-1] < bf16[0]
  # Same trajectory within bf16 noise.
  np.testing.assert_allclose(bf16[-1], f32[-1], rtol=0.05, atol=0.01)


def test_sharded_leaves_fall_back_to_gspmd():
  """Params with a mesh-sharded leaf (embedding-table-like) can't run
  the manual-SPMD wire path (the loss indexes the table as a GLOBAL
  array): the step must fall back to GSPMD and stay correct; table
  grads stay shard-local there (reference gradient.py:197-207)."""
  ctx = Context.get()
  opt = optax.sgd(0.1)
  table = jax.device_put(
      jnp.ones((64, 4)), ctx.sharding(ctx.data_axes, None))

  def loss_fn(params, batch):
    emb = jnp.take(params['table'], batch['ids'], axis=0)
    preds = jax.nn.sigmoid(emb.sum((1, 2)) + (batch['x'] @ params['w'])[:, 0])
    return jnp.mean((preds - batch['label']) ** 2), {'preds': preds}

  params = {'table': table, 'w': jnp.zeros((8, 1), jnp.float32)}
  with hb.scope(comm_gradient_wire_dtype='bfloat16'):
    state = TrainState.create(params, opt, ctx)
    step = make_train_step(loss_fn, opt, ctx, params_template=state.params)
    rng = np.random.RandomState(2)
    b = _toy_batch(rng)
    b['ids'] = rng.randint(0, 64, (64, 2)).astype(np.int32)
    batch = _put(b, ctx)
    state2, _ = step(state, batch)
  # The sharded table still updated (local grads applied; sigmoid is
  # near-saturated so the update is small but nonzero)...
  assert np.abs(np.asarray(state2.params['table']) - 1.0).max() > 1e-7
  # ...and it stayed sharded.
  assert len(state2.params['table'].sharding.device_set) == 8


def test_sparse_step_wire_path_parity():
  """make_sparse_train_step with comm_gradient_wire_dtype set (r3
  self-review findings): (a) the shard_map body must trace — layouts
  carry GLOBAL batch shapes while the body sees per-device slices
  (unpack_embeddings now follows the array's own leading dim); (b)
  per-row embedding grads must carry the GLOBAL 1/B mean weight, not
  the local 1/(B/W) one — detected through the adagrad accumulator,
  which squares the row totals (a W-scaling bug inflates it W^2 = 64x
  here)."""
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor)
  from hybridbackend_tpu.training.sparse_step import (
      SparseTrainState, make_sparse_train_step)

  ctx = Context.get()
  B = 64
  rng = np.random.RandomState(0)
  ids = rng.randint(0, 64, B).astype(np.int32)
  batch_np = {'c0': ids, 'd0': rng.rand(B).astype(np.float32),
              'label': (ids % 2 == 0).astype(np.float32)}

  def ml(dense, emb_f, dense_f, b):
    x = jnp.concatenate(emb_f + dense_f, axis=-1)
    preds = jax.nn.sigmoid((x @ dense['w'])[:, 0])
    p = jnp.clip(preds, 1e-6, 1 - 1e-6)
    y = b['label']
    pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
    return jnp.mean(pel), {'preds': preds}

  def run(wire):
    with hb.scope(comm_gradient_wire_dtype=wire):
      fx = StackedFeatureExtractor(
          [EmbeddingSpec(TableConfig('c0', 64, 8, sharded=True))],
          dense_columns=['d0'], ctx=ctx)
      tables = fx.init(jax.random.PRNGKey(1))
      dense = {'w': jnp.full((9, 1), 0.1, jnp.float32)}
      state = SparseTrainState.create(dense, tables, optax.sgd(0.1),
                                      0.1, ctx)
      step = make_sparse_train_step(fx, ml, optax.sgd(0.1), 0.1, ctx)
      batch = {k: jax.device_put(jnp.asarray(v), ctx.batch_sharding)
               for k, v in batch_np.items()}
      state2, m = step(state, batch)
      name = fx.stacks[0].stacked.name
      return (float(m['loss']),
              np.asarray(state2.table_opt[name].acc[0]),
              np.asarray(state2.dense['w']))

  loss_f, acc_f, w_f = run('float32')
  loss_b, acc_b, w_b = run('bfloat16')
  np.testing.assert_allclose(loss_b, loss_f, rtol=1e-4)
  np.testing.assert_allclose(acc_b, acc_f, rtol=2e-2, atol=1e-6)
  np.testing.assert_allclose(w_b, w_f, rtol=5e-2, atol=1e-4)


def test_sparse_step_wire_path_raw_mode():
  """The raw_model_loss branch of the wire path (sequence models) must
  also trace with per-device slices and produce finite metrics."""
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor)
  from hybridbackend_tpu.training.sparse_step import (
      SparseTrainState, make_sparse_train_step)

  ctx = Context.get()
  B, L = 32, 4
  rng = np.random.RandomState(1)
  batch_np = {'seq': rng.randint(0, 64, (B, L)).astype(np.int32),
              'label': rng.randint(0, 2, B).astype(np.float32)}

  def raw_loss(dense, members, b):
    pooled = members['seq'].mean(axis=1)          # [B, D]
    preds = jax.nn.sigmoid((pooled @ dense['w'])[:, 0])
    pel = (preds - b['label']) ** 2
    return jnp.mean(pel), {'preds': preds}

  with hb.scope(comm_gradient_wire_dtype='bfloat16'):
    fx = StackedFeatureExtractor(
        [EmbeddingSpec(TableConfig('seq', 64, 8, sharded=True))], ctx=ctx)
    tables = fx.init(jax.random.PRNGKey(2))
    dense = {'w': jnp.full((8, 1), 0.1, jnp.float32)}
    state = SparseTrainState.create(dense, tables, optax.sgd(0.1),
                                    0.1, ctx)
    step = make_sparse_train_step(fx, None, optax.sgd(0.1), 0.1, ctx,
                                  raw_model_loss=raw_loss)
    batch = {k: jax.device_put(jnp.asarray(v), ctx.batch_sharding
                               if np.ndim(v) == 1
                               else ctx.sharding(ctx.data_axes, None))
             for k, v in batch_np.items()}
    state2, m = step(state, batch)
  assert np.isfinite(float(m['loss']))
