"""Lane-packed table residency: narrow [V, d] tables stored physically
as [V/p, 128] when ``emb_lane_pack='on'`` (the default, 'off', keeps
[V, d]). Packing must be TRANSPARENT: lookups, gradients, sparse
updates, stacking, export, and checkpoints all agree with the unpacked
layout bit-for-bit (modulo float assoc)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import hybridbackend_tpu as hb
from hybridbackend_tpu.embedding import TableConfig, create_table, lookup
from hybridbackend_tpu.embedding.sparse_update import (
    init_adagrad_state, sparse_adagrad_apply)

V, D, B = 1024, 16, 256


@pytest.mark.parametrize('mode,packed', [
    (None, False), ('off', False), ('auto', False), ('on', True)])
def test_lane_pack_policy(mode, packed):
  """'off' is the default and 'auto' is its alias; only 'on' packs."""
  cfg = TableConfig('t', V, D)
  if mode is None:
    assert hb.OPTIONS['emb_lane_pack'] == 'off'
    assert cfg.pack_factor() == 1
    return
  with hb.scope(emb_lane_pack=mode):
    assert cfg.pack_factor() == (128 // D if packed else 1)


def _host_logical(table, cfg, ctx=None):
  """Host view of a possibly-packed table in LOGICAL [V, D] layout."""
  host = np.asarray(table)
  if host.shape[1] != cfg.dim:
    host = host.reshape(-1, cfg.dim)
  return host


def test_packed_physical_shape_and_lookup():
  with hb.scope(emb_lane_pack='on'):
    cfg = TableConfig('pk', V, D)
    tbl = create_table(cfg, jax.random.PRNGKey(0))
    assert tbl.shape == (V // 8, 128), tbl.shape   # 8x fewer HBM bytes
    host = _host_logical(tbl, cfg)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, B).astype(np.int32)
    for strategy in ('allgather', 'alltoall', 'gspmd'):
      got = np.asarray(lookup(tbl, jnp.asarray(ids), cfg,
                              strategy=strategy))
      np.testing.assert_allclose(got, host[ids], atol=1e-6,
                                 err_msg=strategy)
    # -1 / out-of-range ids read zeros (contract preserved).
    bad = jnp.asarray([-1, V + 7, 3] + [0] * 5, jnp.int32)
    got = np.asarray(lookup(tbl, bad, cfg))
    assert (got[0] == 0).all() and (got[1] == 0).all()
    np.testing.assert_allclose(got[2], host[3], atol=1e-6)


def test_packed_gradients():
  with hb.scope(emb_lane_pack='on'):
    cfg = TableConfig('pg', V, D)
    tbl = create_table(cfg, jax.random.PRNGKey(1))
    rng = np.random.RandomState(1)
    ids_np = rng.randint(0, V, B).astype(np.int32)
    ids = jnp.asarray(ids_np)

    def loss(t):
      return jnp.sum(lookup(t, ids, cfg) ** 2)

    g = np.asarray(jax.grad(loss)(tbl)).reshape(-1, D)
    host = _host_logical(tbl, cfg)
    expected = np.zeros_like(host)
    for i in ids_np:
      expected[i] += 2 * host[i]
    np.testing.assert_allclose(g[:V], expected[:V], rtol=1e-5, atol=1e-6)


def test_packed_sparse_adagrad_matches_unpacked():
  rng = np.random.RandomState(2)
  base = rng.randn(V, D).astype(np.float32) * 0.1
  ids = rng.randint(0, V, B).astype(np.int32)
  demb = rng.randn(B, D).astype(np.float32)

  def run(mode):
    with hb.scope(emb_lane_pack=mode):
      cfg = TableConfig('ps', V, D, initializer=lambda k, s:
                        jnp.asarray(base[:s[0]]) if s[0] <= V else
                        jnp.concatenate([jnp.asarray(base),
                                         jnp.zeros((s[0] - V, D))]))
      tbl = create_table(cfg, jax.random.PRNGKey(0))
      st = init_adagrad_state(tbl, 0.1)
      t2, s2 = sparse_adagrad_apply(tbl, st, jnp.asarray(ids),
                                    jnp.asarray(demb), cfg, 0.1)
      return (_host_logical(t2, cfg)[:V],
              _host_logical(s2.acc[0], cfg)[:V])

  t_off, a_off = run('off')
  t_on, a_on = run('on')
  np.testing.assert_allclose(t_on, t_off, rtol=1e-5, atol=1e-7)
  np.testing.assert_allclose(a_on, a_off, rtol=1e-5, atol=1e-7)


def test_packed_trainer_end_to_end_matches_unpacked():
  """Full SparseTrainer (stacked tables) parity: packed vs unpacked
  training produce the same losses and final logical tables."""
  from hybridbackend_tpu.models import EmbeddingSpec, StackedFeatureExtractor

  def batches(n, seed):
    r = np.random.RandomState(seed)
    for _ in range(n):
      c = r.randint(0, 300, 32).astype(np.int32)
      yield {'c0': c, 'd0': r.rand(32).astype(np.float32),
             'label': (c % 2 == 0).astype(np.float32)}

  def ml(dense, emb_f, dense_f, b):
    x = jnp.concatenate(emb_f + dense_f, axis=-1)
    p = jnp.clip(jax.nn.sigmoid((x @ dense['w'])[:, 0]), 1e-6, 1 - 1e-6)
    y = b['label']
    pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
    return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}

  def run(mode):
    with hb.scope(emb_lane_pack=mode):
      fx = StackedFeatureExtractor(
          [EmbeddingSpec(TableConfig('c0', 300, D))], dense_columns=['d0'])
      tr = hb.SparseTrainer(
          fx, ml, {'w': jnp.zeros((D + 1, 1), jnp.float32)},
          dense_optimizer=optax.sgd(0.5), table_lr=0.2,
          rng=jax.random.PRNGKey(7))
      m = tr.train(batches(15, seed=3), sync=False)
      name = fx.stacks[0].stacked.name
      host = np.asarray(tr.state.tables[name])
      if host.shape[1] != D:
        host = host.reshape(-1, D)
      return m['loss'], host[:300]

  loss_off, t_off = run('off')
  loss_on, t_on = run('on')
  np.testing.assert_allclose(loss_on, loss_off, rtol=1e-5)
  np.testing.assert_allclose(t_on, t_off, rtol=1e-4, atol=1e-6)


def test_packed_export_serves_logical_rows(tmp_path):
  from hybridbackend_tpu.models import EmbeddingSpec, StackedFeatureExtractor
  from hybridbackend_tpu.training.saved_model import Served

  def ml(dense, emb_f, dense_f, b):
    x = jnp.concatenate(emb_f + dense_f, axis=-1)
    p = jax.nn.sigmoid((x @ dense['w'])[:, 0])
    pel = (p - b['label']) ** 2
    return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}

  with hb.scope(emb_lane_pack='on'):
    fx = StackedFeatureExtractor(
        [EmbeddingSpec(TableConfig('c0', 300, D))], dense_columns=['d0'])
    tr = hb.SparseTrainer(
        fx, ml, {'w': jnp.zeros((D + 1, 1), jnp.float32)},
        dense_optimizer=optax.sgd(0.3), table_lr=0.2,
        rng=jax.random.PRNGKey(5))
    r = np.random.RandomState(4)
    tr.train(({'c0': r.randint(0, 300, 32).astype(np.int32),
               'd0': r.rand(32).astype(np.float32),
               'label': np.ones(32, np.float32)} for _ in range(5)),
             sync=False)
    b = {'c0': np.arange(32, dtype=np.int32),
         'd0': r.rand(32).astype(np.float32),
         'label': np.zeros(32, np.float32)}
    path = tr.export_saved_model(str(tmp_path / 'pk'), b)
    _, aux = tr._eval_fn(tr.params, {k: jnp.asarray(v)
                                     for k, v in b.items()})
  served = Served(path)
  np.testing.assert_allclose(served.predict(b), np.asarray(aux['preds']),
                             rtol=1e-4, atol=1e-5)


def test_adam_rejects_packed_tables():
  with hb.scope(emb_lane_pack='on'):
    cfg = TableConfig('pa', V, D)
    tbl = create_table(cfg, jax.random.PRNGKey(0))
    from hybridbackend_tpu.embedding.sparse_update import (
        init_adam_state, sparse_adam_apply)
    st = init_adam_state(tbl)
    with pytest.raises(ValueError, match='lane pack'):
      sparse_adam_apply(tbl, st, jnp.zeros((8,), jnp.int32),
                        jnp.zeros((8, D)), cfg, 0.1, step=1)


def test_adam_trainer_auto_policy_never_packs():
  """SparseTrainer(table_optimizer='adam') on a SINGLE-device mesh must
  not crash even where emb_lane_pack='on' packs narrow tables: LazyAdam
  is incompatible with packing, so the trainer disables packing before
  materializing tables."""
  from jax.sharding import Mesh
  from hybridbackend_tpu.framework.context import Context
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor)
  ctx1 = Context(Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                      ('dcn', 'ici')))
  assert ctx1.world_size == 1
  fx = StackedFeatureExtractor(
      [EmbeddingSpec(TableConfig('c0', 64, 16))], dense_columns=['d0'],
      ctx=ctx1)

  def ml(dense, emb_f, dense_f, b):
    x = jnp.concatenate(emb_f + dense_f, axis=-1)
    p = jax.nn.sigmoid((x @ dense['w'])[:, 0])
    pel = (p - b['label']) ** 2
    return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}

  with hb.scope(emb_lane_pack='on'):
    tr = hb.SparseTrainer(
        fx, ml, {'w': jnp.zeros((17, 1), jnp.float32)},
        dense_optimizer=optax.sgd(0.1), table_lr=0.1,
        table_optimizer='adam', rng=jax.random.PRNGKey(0), ctx=ctx1)
  name = fx.stacks[0].stacked.name
  assert tr.state.tables[name].shape[1] == 16  # unpacked
  r = np.random.RandomState(0)
  m = tr.train(({'c0': r.randint(0, 64, 16).astype(np.int32),
                 'd0': r.rand(16).astype(np.float32),
                 'label': np.ones(16, np.float32)} for _ in range(3)),
               sync=False)
  assert np.isfinite(m['loss'])


def test_packed_multi_member_unaligned_boundary():
  """Two stacked members whose boundary (vocab 300) is NOT a multiple
  of the pack factor (8): packed rows at the boundary hold rows of BOTH
  members; training parity with the unpacked layout must still hold
  (lane slices are disjoint per logical row regardless of member)."""
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor)

  def batches(n, seed):
    r = np.random.RandomState(seed)
    for _ in range(n):
      a = r.randint(0, 300, 32).astype(np.int32)
      b = r.randint(0, 100, 32).astype(np.int32)
      yield {'a': a, 'b': b,
             'label': ((a + b) % 2 == 0).astype(np.float32)}

  def ml(dense, emb_f, dense_f, b):
    x = jnp.concatenate(emb_f + dense_f, axis=-1)
    p = jnp.clip(jax.nn.sigmoid((x @ dense['w'])[:, 0]), 1e-6, 1 - 1e-6)
    y = b['label']
    pel = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
    return jnp.mean(pel), {'preds': p, 'per_example_loss': pel}

  def run(mode):
    with hb.scope(emb_lane_pack=mode):
      fx = StackedFeatureExtractor(
          [EmbeddingSpec(TableConfig('a', 300, D)),
           EmbeddingSpec(TableConfig('b', 100, D))])
      tr = hb.SparseTrainer(
          fx, ml, {'w': jnp.zeros((2 * D, 1), jnp.float32)},
          dense_optimizer=optax.sgd(0.5), table_lr=0.2,
          rng=jax.random.PRNGKey(9))
      m = tr.train(batches(10, seed=5), sync=False)
      name = fx.stacks[0].stacked.name
      host = np.asarray(tr.state.tables[name])
      if host.shape[1] != D:
        host = host.reshape(-1, D)
      return m['loss'], host[:400]

  loss_off, t_off = run('off')
  loss_on, t_on = run('on')
  np.testing.assert_allclose(loss_on, loss_off, rtol=1e-5)
  np.testing.assert_allclose(t_on, t_off, rtol=1e-4, atol=1e-6)
