"""Tests for row-sparse table updates: must match dense-optax training
numerically (Adagrad semantics) while never materializing dense table
grads."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from hybridbackend_tpu.embedding import TableConfig, create_table, lookup
from hybridbackend_tpu.embedding.sparse_update import (
    init_adagrad_state, sparse_adagrad_apply, sparse_sgd_apply)
from hybridbackend_tpu.models import EmbeddingSpec, StackedFeatureExtractor
from hybridbackend_tpu.models import stacked_dcn_v2_apply, stacked_dcn_v2_init
from hybridbackend_tpu.training.sparse_step import (
    SparseTrainState, make_sparse_train_step)

VOCAB, DIM, BATCH = 64, 8, 32


def reference_adagrad(table, acc, ids, demb, lr, eps=1e-7):
  """NumPy reference: dedup ids, accumulate squared row-total grads."""
  table, acc = table.copy(), acc.copy()
  for row in np.unique(ids):
    g = demb[ids == row].sum(0)
    acc[row] += g * g
    table[row] -= lr * g / (np.sqrt(acc[row]) + eps)
  return table, acc


class TestSparseAdagradSharded:

  def _setup(self, vocab=VOCAB):
    cfg = TableConfig('t', vocab, DIM)
    table = create_table(cfg, jax.random.PRNGKey(0))
    state = init_adagrad_state(table, initial=0.1)
    return cfg, table, state

  def test_matches_reference(self):
    cfg, table, state = self._setup()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, BATCH)
    demb = rng.randn(BATCH, DIM).astype(np.float32)
    new_table, new_state = sparse_adagrad_apply(
        table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
        cfg, lr=0.1)
    want_t, want_a = reference_adagrad(
        np.asarray(table), np.full((VOCAB, DIM), 0.1, np.float32),
        ids, demb, 0.1)
    np.testing.assert_allclose(np.asarray(new_table), want_t, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(new_state.acc[0]), want_a,
                               rtol=1e-5)

  def test_untouched_rows_unchanged(self):
    cfg, table, state = self._setup()
    ids = jnp.asarray([3] * BATCH, jnp.int32)
    demb = jnp.ones((BATCH, DIM))
    new_table, _ = sparse_adagrad_apply(table, state, ids, demb, cfg, 0.1)
    diff = np.abs(np.asarray(new_table) - np.asarray(table)).sum(1)
    assert (diff[np.arange(VOCAB) != 3] == 0).all()
    assert diff[3] > 0

  def test_sharding_preserved(self):
    cfg, table, state = self._setup()
    ids = jnp.arange(BATCH, dtype=jnp.int32)
    new_table, new_state = sparse_adagrad_apply(
        table, state, ids, jnp.ones((BATCH, DIM)), cfg, 0.1)
    assert len(new_table.sharding.device_set) == 8
    assert len(new_state.acc[0].sharding.device_set) == 8

  def test_replicated_table(self):
    cfg = TableConfig('t', VOCAB, DIM, sharded=False)
    table = create_table(cfg, jax.random.PRNGKey(0))
    state = init_adagrad_state(table, 0.1)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, VOCAB, BATCH)
    demb = rng.randn(BATCH, DIM).astype(np.float32)
    new_table, _ = sparse_adagrad_apply(
        table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
        cfg, 0.1)
    want_t, _ = reference_adagrad(
        np.asarray(table), np.full((VOCAB, DIM), 0.1, np.float32),
        ids, demb, 0.1)
    np.testing.assert_allclose(np.asarray(new_table), want_t, rtol=1e-5)

  def test_nodedup_matches_dedup_without_duplicates(self):
    cfg, table, state = self._setup()
    ids = np.random.RandomState(2).permutation(VOCAB)[:BATCH]
    demb = np.random.RandomState(3).randn(BATCH, DIM).astype(np.float32)
    t1, s1 = sparse_adagrad_apply(
        table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
        cfg, 0.1, dedup=True)
    t2, s2 = sparse_adagrad_apply(
        table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
        cfg, 0.1, dedup=False)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s1.acc[0]),
                               np.asarray(s2.acc[0]), rtol=1e-6)

  def test_nodedup_tf_semantics_with_duplicates(self):
    """Duplicates accumulate per-occurrence squares; every occurrence's
    update divides by the post-accumulation denominator."""
    for sharded in (True, False):
      cfg = TableConfig('t', VOCAB, DIM, sharded=sharded)
      table = create_table(cfg, jax.random.PRNGKey(0))
      state = init_adagrad_state(table, 0.1)
      rng = np.random.RandomState(4)
      ids = rng.randint(0, 8, BATCH)  # heavy duplication
      demb = rng.randn(BATCH, DIM).astype(np.float32)
      got_t, got_s = sparse_adagrad_apply(
          table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
          cfg, 0.1, dedup=False)
      want_t = np.asarray(table).copy()
      want_a = np.full((VOCAB, DIM), 0.1, np.float32)
      for i in range(BATCH):
        want_a[ids[i]] += demb[i] * demb[i]
      for i in range(BATCH):
        want_t[ids[i]] -= 0.1 * demb[i] / (np.sqrt(want_a[ids[i]]) + 1e-7)
      np.testing.assert_allclose(np.asarray(got_s.acc[0]), want_a,
                                 rtol=1e-5)
      np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=1e-4)

  def test_sgd(self):
    cfg, table, _ = self._setup()
    ids = jnp.asarray([5, 5, 9] + [0] * (BATCH - 3), jnp.int32)
    demb = jnp.ones((BATCH, DIM))
    new_table = sparse_sgd_apply(table, ids, demb, cfg, lr=0.5)
    d = np.asarray(new_table) - np.asarray(table)
    np.testing.assert_allclose(d[5], -1.0, rtol=1e-6)  # two dups
    np.testing.assert_allclose(d[9], -0.5, rtol=1e-6)


class TestSparseTrainStep:

  def _make(self):
    specs = [EmbeddingSpec(TableConfig('cat0', 300, DIM)),
             EmbeddingSpec(TableConfig('cat1', 100, DIM))]
    fx = StackedFeatureExtractor(specs, dense_columns=['dense0'])
    key = jax.random.PRNGKey(0)
    kt, kn = jax.random.split(key)
    tables = fx.init(kt)
    dense = stacked_dcn_v2_init(kn, [DIM, DIM, 1], [16, 1])

    def model_loss(dense_params, emb_f, dense_f, batch):
      preds = jnp.clip(stacked_dcn_v2_apply(dense_params, emb_f + dense_f),
                       1e-6, 1 - 1e-6)
      y = batch['label']
      loss = -jnp.mean(y * jnp.log(preds) + (1 - y) * jnp.log(1 - preds))
      return loss, {'preds': preds}

    opt = optax.adam(3e-3)
    state = SparseTrainState.create(dense, tables, opt)
    step = make_sparse_train_step(fx, model_loss, opt, table_lr=0.1)
    return state, step

  def _batch(self, rng):
    cat0 = rng.randint(0, 300, BATCH * 2)
    return {'cat0': jnp.asarray(cat0, jnp.int32),
            'cat1': jnp.asarray(rng.randint(0, 100, BATCH * 2), jnp.int32),
            'dense0': jnp.asarray(rng.rand(BATCH * 2), jnp.float32),
            'label': jnp.asarray((cat0 % 3 == 0).astype(np.float32))}

  def test_trains(self):
    state, step = self._make()
    rng = np.random.RandomState(0)
    fixed = self._batch(rng)
    state, m = step(state, fixed)
    l0 = float(m['loss'])
    for _ in range(120):
      state, m = step(state, fixed)
    assert float(m['loss']) < l0 * 0.5, (l0, float(m['loss']))

  def test_no_dense_table_grad_in_hlo(self):
    """The compiled step must not contain a [V, D]-shaped scatter-into-
    zeros for the table gradient (the thing we're eliminating)."""
    state, step = self._make()
    b = self._batch(np.random.RandomState(1))
    hlo = step.lower(state, b).compile().as_text()
    # The post-SPMD HLO is per-shard: the stacked table (408 rows over
    # 8 devices) appears as f32[51,8] shards. A dense optax path would
    # add full-shard elementwise multiplies (adagrad over every row);
    # the sparse path must have none.
    assert 'f32[51,8]' in hlo  # table shards flow through
    n_full_mul = hlo.count('multiply(f32[51,8]')
    assert n_full_mul == 0, n_full_mul

  def test_step_counter_and_sharding(self):
    state, step = self._make()
    state, _ = step(state, self._batch(np.random.RandomState(2)))
    assert int(np.asarray(state.step)) == 1
    for t in state.tables.values():
      assert len(t.sharding.device_set) == 8


class TestSparseAdam:
  """LazyAdam: moments decay only on touched rows."""

  def _reference(self, table, m, v, ids, demb, lr, step,
                 b1=0.9, b2=0.999, eps=1e-8):
    table, m, v = table.copy(), m.copy(), v.copy()
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for r in np.unique(ids):
      g = demb[ids == r].sum(0)
      m[r] = b1 * m[r] + (1 - b1) * g
      v[r] = b2 * v[r] + (1 - b2) * g * g
      table[r] -= lr * (m[r] / bc1) / (np.sqrt(v[r] / bc2) + eps)
    return table, m, v

  @pytest.mark.parametrize('sharded', [True, False])
  def test_matches_reference(self, sharded):
    from hybridbackend_tpu.embedding.sparse_update import (
        init_adam_state, sparse_adam_apply)
    cfg = TableConfig('t', VOCAB, DIM, sharded=sharded)
    table = create_table(cfg, jax.random.PRNGKey(0))
    state = init_adam_state(table)
    rng = np.random.RandomState(13)
    ids = rng.randint(0, VOCAB, BATCH)
    demb = rng.randn(BATCH, DIM).astype(np.float32)
    got_t, got_s = sparse_adam_apply(
        table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
        cfg, lr=0.01, step=1)
    want_t, want_m, want_v = self._reference(
        np.asarray(table), np.zeros((VOCAB, DIM), np.float32),
        np.zeros((VOCAB, DIM), np.float32), ids, demb, 0.01, 1)
    np.testing.assert_allclose(np.asarray(got_t), want_t,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_s.acc[0]), want_m,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_s.acc[1]), want_v,
                               rtol=1e-3, atol=1e-5)

  def test_untouched_moments_do_not_decay(self):
    from hybridbackend_tpu.embedding.sparse_update import (
        SparseOptState, sparse_adam_apply)
    cfg = TableConfig('t', VOCAB, DIM, sharded=False)
    table = create_table(cfg, jax.random.PRNGKey(1))
    m0 = jnp.ones((VOCAB, DIM))
    state = SparseOptState(acc=(m0, m0))
    ids = jnp.asarray([3] * BATCH, jnp.int32)
    demb = jnp.ones((BATCH, DIM))
    _, s = sparse_adam_apply(table, state, ids, demb, cfg,
                             lr=0.01, step=5)
    m = np.asarray(s.acc[0])
    assert (m[np.arange(VOCAB) != 3] == 1.0).all()  # no decay
    assert not np.allclose(m[3], 1.0)

  def test_column_sharded(self):
    from hybridbackend_tpu.embedding.sparse_update import (
        init_adam_state, sparse_adam_apply)
    cfg = TableConfig('t', VOCAB, 32, partition='column', sharded=True)
    table = create_table(cfg, jax.random.PRNGKey(2))
    state = init_adam_state(table)
    rng = np.random.RandomState(14)
    ids = rng.randint(0, VOCAB, BATCH)
    demb = rng.randn(BATCH, 32).astype(np.float32)
    got_t, _ = sparse_adam_apply(
        table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
        cfg, lr=0.01, step=1)
    want_t, _, _ = self._reference(
        np.asarray(table), np.zeros((VOCAB, 32), np.float32),
        np.zeros((VOCAB, 32), np.float32), ids, demb, 0.01, 1)
    np.testing.assert_allclose(np.asarray(got_t), want_t,
                               rtol=1e-3, atol=1e-5)

  def test_sparse_train_step_with_adam(self):
    from hybridbackend_tpu.models import (EmbeddingSpec,
                                          StackedFeatureExtractor,
                                          stacked_dcn_v2_apply,
                                          stacked_dcn_v2_init)
    from hybridbackend_tpu.training.sparse_step import (
        SparseTrainState, make_sparse_train_step)
    specs = [EmbeddingSpec(TableConfig('c0', 256, DIM))]
    fx = StackedFeatureExtractor(specs, dense_columns=['d0'])
    kt, kn = jax.random.split(jax.random.PRNGKey(0))
    tables = fx.init(kt)
    dense = stacked_dcn_v2_init(kn, [DIM, 1], [16, 1])

    def model_loss(dp, emb_f, dense_f, batch):
      p = jnp.clip(stacked_dcn_v2_apply(dp, emb_f + dense_f),
                   1e-6, 1 - 1e-6)
      y = batch['label']
      return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p)), {}

    opt = optax.adam(3e-3)
    state = SparseTrainState.create(dense, tables, opt, adam=True)
    step = make_sparse_train_step(fx, model_loss, opt, table_lr=0.01,
                                  table_optimizer='adam')
    rng = np.random.RandomState(0)
    c0 = rng.randint(0, 256, 64)
    batch = {'c0': jnp.asarray(c0, jnp.int32),
             'd0': jnp.asarray(rng.rand(64), jnp.float32),
             'label': jnp.asarray((c0 % 3 == 0).astype(np.float32))}
    losses = []
    for _ in range(80):
      state, metrics = step(state, batch)
      losses.append(float(metrics['loss']))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])

  def test_adam_zero_total_rows_still_decay(self):
    """An id present with an exactly-zero gradient total must update
    its moments (TF LazyAdam updates every indexed row)."""
    from hybridbackend_tpu.embedding.sparse_update import (
        SparseOptState, sparse_adam_apply)
    cfg = TableConfig('t', VOCAB, DIM, sharded=False)
    table = create_table(cfg, jax.random.PRNGKey(4))
    m0 = jnp.ones((VOCAB, DIM))
    state = SparseOptState(acc=(m0, m0))
    # id 7 appears twice with cancelling grads → zero total
    ids = jnp.asarray([7, 7] + [3] * (BATCH - 2), jnp.int32)
    g = np.zeros((BATCH, DIM), np.float32)
    g[0] = 1.0
    g[1] = -1.0
    g[2:] = 0.5
    _, s = sparse_adam_apply(table, state, ids, jnp.asarray(g), cfg,
                             lr=0.01, step=3)
    m = np.asarray(s.acc[0])
    np.testing.assert_allclose(m[7], 0.9, rtol=1e-5)  # decayed, zero grad
    assert (m[np.arange(VOCAB)[(np.arange(VOCAB) != 7)
                               & (np.arange(VOCAB) != 3)]] == 1.0).all()

  def test_bf16_tables_supported(self):
    """bf16 table storage (half HBM traffic) follows the f32 reference
    within bf16 rounding."""
    cfg = TableConfig('t', VOCAB, DIM, dtype=jnp.bfloat16, sharded=False)
    table = create_table(cfg, jax.random.PRNGKey(6))
    assert table.dtype == jnp.bfloat16
    state = init_adagrad_state(table, 0.1)
    rng = np.random.RandomState(15)
    ids = jnp.asarray(rng.randint(0, VOCAB, BATCH), jnp.int32)
    g = jnp.asarray(rng.randn(BATCH, DIM), jnp.float32)
    t2, _ = sparse_adagrad_apply(table, state, ids, g, cfg, 0.1)
    assert t2.dtype == jnp.bfloat16
    want_t, _ = reference_adagrad(
        np.asarray(table, np.float32), np.full((VOCAB, DIM), 0.1, np.float32),
        np.asarray(ids), np.asarray(g), 0.1)
    np.testing.assert_allclose(np.asarray(t2, np.float32), want_t,
                               rtol=2e-2, atol=1e-2)


class TestRawModelLoss:
  """``raw_model_loss`` hands the model UNCOMBINED per-member
  embeddings (sequence models; reference DIN `model.py:154+` consumes
  the [B, L, D] history before any combiner)."""

  def _setup(self):
    specs = [EmbeddingSpec(TableConfig('seq', 120, DIM, combiner='sum'),
                           column='seq'),
             EmbeddingSpec(TableConfig('cat', 60, DIM))]
    fx = StackedFeatureExtractor(specs, dense_columns=['d0'])
    key = jax.random.PRNGKey(3)
    kt, kn = jax.random.split(key)
    tables = fx.init(kt)
    dense = stacked_dcn_v2_init(kn, [DIM, DIM, 1], [16, 1])
    rng = np.random.RandomState(7)
    seq = rng.randint(0, 120, (BATCH, 6))
    batch = {
        'seq': jnp.asarray(seq, jnp.int32),
        'seq_mask': jnp.asarray(
            np.arange(6)[None, :] < rng.randint(1, 7, (BATCH, 1))),
        'cat': jnp.asarray(rng.randint(0, 60, BATCH), jnp.int32),
        'd0': jnp.asarray(rng.rand(BATCH), jnp.float32),
        'label': jnp.asarray((seq[:, 0] % 2).astype(np.float32)),
    }
    return fx, tables, dense, batch

  @staticmethod
  def _bce(dense_params, emb_f, dense_f, batch):
    preds = jnp.clip(
        stacked_dcn_v2_apply(dense_params, emb_f + dense_f),
        1e-6, 1 - 1e-6)
    y = batch['label']
    return -jnp.mean(y * jnp.log(preds)
                     + (1 - y) * jnp.log(1 - preds)), {}

  def test_matches_combined_mode_exactly(self):
    """Reimplementing the sum-combiner inside raw_model_loss must give
    the same step as combined mode (same grads -> same tables)."""
    fx, tables, dense, batch = self._setup()
    opt = optax.adam(3e-3)

    def raw_loss(dense_params, members, b):
      m = b['seq_mask'].astype(members['seq'].dtype)
      seq_f = jnp.sum(members['seq'] * m[..., None], axis=-2)
      emb_f = [seq_f, members['cat']]
      return self._bce(dense_params, emb_f,
                       [b['d0'][:, None].astype(jnp.float32)], b)

    s_raw = SparseTrainState.create(dense, tables, opt)
    s_cmb = SparseTrainState.create(dense, tables, opt)
    step_raw = make_sparse_train_step(fx, None, opt, table_lr=0.1,
                                      raw_model_loss=raw_loss,
                                      donate_state=False)
    step_cmb = make_sparse_train_step(fx, self._bce, opt, table_lr=0.1,
                                      donate_state=False)
    for _ in range(2):
      s_raw, m_raw = step_raw(s_raw, batch)
      s_cmb, m_cmb = step_cmb(s_cmb, batch)
    np.testing.assert_allclose(float(m_raw['loss']),
                               float(m_cmb['loss']), rtol=1e-6)
    for name in s_raw.tables:
      np.testing.assert_allclose(np.asarray(s_raw.tables[name]),
                                 np.asarray(s_cmb.tables[name]),
                                 rtol=1e-6, atol=1e-7)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7),
        s_raw.dense, s_cmb.dense)

  def test_attention_over_raw_sequence_trains(self):
    """DIN-style use: attention pooling over the raw [B, L, D] history
    keyed by a candidate — only expressible with raw_model_loss."""
    from hybridbackend_tpu.models import din_apply, din_init
    fx, tables, _, batch = self._setup()
    net = din_init(jax.random.PRNGKey(9), DIM, num_profile_features=1,
                   num_dense=1, dnn_hidden_units=(16, 8),
                   att_hidden_size=(8,))

    def raw_loss(net_params, members, b):
      keys = members['seq']                       # [B, L, D] uncombined
      query = members['cat']                      # candidate [B, D]
      preds = jnp.clip(
          din_apply(net_params, query, keys,
                    b['seq_mask'].astype(jnp.float32), [query],
                    [b['d0'][:, None]]),
          1e-6, 1 - 1e-6)
      y = b['label']
      return -jnp.mean(y * jnp.log(preds)
                       + (1 - y) * jnp.log(1 - preds)), {}

    opt = optax.adam(3e-3)
    state = SparseTrainState.create(net, tables, opt)
    step = make_sparse_train_step(fx, None, opt, table_lr=0.1,
                                  raw_model_loss=raw_loss,
                                  donate_state=False)
    state, m = step(state, batch)
    l0 = float(m['loss'])
    for _ in range(80):
      state, m = step(state, batch)
    assert float(m['loss']) < l0 * 0.7, (l0, float(m['loss']))


class TestUpdateExchange:
  """The alltoall-routed gradient return (reference reverse alltoallv,
  collective.py:326-350): exactness vs the allgather route for every
  optimizer, lossless overflow fallback, and a wire-volume HLO check."""

  def _setup(self, vocab=VOCAB):
    cfg = TableConfig('t', vocab, DIM)
    table = create_table(cfg, jax.random.PRNGKey(0))
    return cfg, table

  def _ids_grads(self, seed=0, batch=BATCH, hi=VOCAB):
    rng = np.random.RandomState(seed)
    ids = jnp.asarray(rng.randint(0, hi, batch), jnp.int32)
    demb = jnp.asarray(rng.randn(batch, DIM).astype(np.float32))
    return ids, demb

  def test_adagrad_alltoall_matches_allgather(self):
    import hybridbackend_tpu as hb
    cfg, table = self._setup()
    state = init_adagrad_state(table, 0.1)
    ids, demb = self._ids_grads(11)
    with hb.scope(emb_update_exchange='allgather'):
      t1, s1 = sparse_adagrad_apply(table, state, ids, demb, cfg, 0.1)
    with hb.scope(emb_update_exchange='alltoall'):
      t2, s2 = sparse_adagrad_apply(table, state, ids, demb, cfg, 0.1)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s1.acc[0]),
                               np.asarray(s2.acc[0]), rtol=1e-6)

  def test_sgd_alltoall_matches_allgather(self):
    import hybridbackend_tpu as hb
    cfg, table = self._setup()
    ids, demb = self._ids_grads(12)
    with hb.scope(emb_update_exchange='allgather'):
      t1 = sparse_sgd_apply(table, ids, demb, cfg, 0.3)
    with hb.scope(emb_update_exchange='alltoall'):
      t2 = sparse_sgd_apply(table, ids, demb, cfg, 0.3)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6)

  def test_adam_alltoall_matches_allgather(self):
    import hybridbackend_tpu as hb
    from hybridbackend_tpu.embedding.sparse_update import (
        init_adam_state, sparse_adam_apply)
    cfg, table = self._setup()
    state = init_adam_state(table)
    ids, demb = self._ids_grads(13)
    with hb.scope(emb_update_exchange='allgather'):
      t1, s1 = sparse_adam_apply(table, state, ids, demb, cfg, 1e-2, 1)
    with hb.scope(emb_update_exchange='alltoall'):
      t2, s2 = sparse_adam_apply(table, state, ids, demb, cfg, 1e-2, 1)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6,
                               atol=1e-9)
    for a, b in zip(s1.acc, s2.acc):
      # atol: summation-order float noise on near-zero moment entries.
      np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                 atol=1e-9)

  def test_overflow_falls_back_lossless(self):
    """All ids owned by shard 0 with a tiny bucket ratio: buckets
    overflow, the lax.cond fallback reroutes via allgather, results stay
    exact (no dropped gradients)."""
    import hybridbackend_tpu as hb
    cfg, table = self._setup()
    state = init_adagrad_state(table, 0.1)
    rng = np.random.RandomState(5)
    ids = rng.randint(0, VOCAB // 8, BATCH)   # all rows in shard 0
    demb = rng.randn(BATCH, DIM).astype(np.float32)
    with hb.scope(emb_update_exchange='alltoall',
                  emb_update_bucket_ratio=0.25):
      t2, s2 = sparse_adagrad_apply(
          table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
          cfg, 0.1)
    want_t, want_a = reference_adagrad(
        np.asarray(table), np.full((VOCAB, DIM), 0.1, np.float32),
        ids, demb, 0.1)
    np.testing.assert_allclose(np.asarray(t2), want_t, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s2.acc[0]), want_a, rtol=1e-5)

  def test_nodedup_alltoall_keeps_tf_semantics(self):
    """dedup=False ships per-occurrence grads uncombined through the
    alltoall route; per-occurrence squares still accumulate."""
    import hybridbackend_tpu as hb
    cfg, table = self._setup()
    state = init_adagrad_state(table, 0.1)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 8, BATCH)  # heavy duplication, all shard 0
    demb = rng.randn(BATCH, DIM).astype(np.float32)
    with hb.scope(emb_update_exchange='alltoall'):
      got_t, got_s = sparse_adagrad_apply(
          table, state, jnp.asarray(ids, jnp.int32), jnp.asarray(demb),
          cfg, 0.1, dedup=False)
    want_a = np.full((VOCAB, DIM), 0.1, np.float32)
    want_t = np.asarray(table).copy()
    for i in range(BATCH):
      want_a[ids[i]] += demb[i] * demb[i]
    for i in range(BATCH):
      want_t[ids[i]] -= 0.1 * demb[i] / (np.sqrt(want_a[ids[i]]) + 1e-7)
    np.testing.assert_allclose(np.asarray(got_s.acc[0]), want_a, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=1e-4)

  def test_hlo_wire_volume(self):
    """The exchanged payload must be [W, cap, D] per device (cap ∝ b/W),
    NOT the allgather's [W*b, D]: assert the HLO contains the bucketed
    all-to-all and no full-payload gradient all-gather."""
    import re
    import hybridbackend_tpu as hb
    from hybridbackend_tpu.embedding.sparse_update import (
        _update_bucket_cap)
    cfg, table = self._setup()
    state = init_adagrad_state(table, 0.1)
    batch = 512
    ids, demb = self._ids_grads(14, batch=batch)
    world = 8
    cap = _update_bucket_cap(batch // world, world)
    assert cap * world < batch  # the point: payload shrinks below [W*b]
    with hb.scope(emb_update_exchange='alltoall',
                  emb_update_overflow_fallback=False):
      hlo = jax.jit(
          lambda t, s, i, g: sparse_adagrad_apply(t, s, i, g, cfg, 0.1)
      ).lower(table, state, ids, demb).compile().as_text()
    # Bucketed payload exchange present: an all-to-all whose per-peer
    # payload is [cap, D] (lowered as W operands of f32[1, cap, D]).
    a2a_lines = [l for l in hlo.splitlines() if 'all-to-all' in l]
    assert any(re.search(rf'f32\[(1,)?{cap},{DIM}\]', l) or
               re.search(rf'f32\[{world},{cap},{DIM}\]', l)
               for l in a2a_lines), a2a_lines[:10]
    # No full-gradient allgather: f32[batch, DIM] -> f32[W*b, DIM].
    big = rf'f32\[{batch},{DIM}\]'
    bad = [l for l in hlo.splitlines()
           if 'all-gather' in l and re.search(big, l)]
    assert not bad, bad


def test_bf16_table_storage_trains():
  """Half-precision embedding storage (TableConfig(dtype=bfloat16))
  halves table HBM; lookups, grads, and the fused sparse Adagrad all
  follow the table dtype (accumulator slots ride bf16 too — choose
  f32 tables when exact slot precision matters)."""
  import jax
  import jax.numpy as jnp

  cfg = TableConfig('bh', 512, 16, dtype=jnp.bfloat16, sharded=False)
  tbl = create_table(cfg, jax.random.PRNGKey(0))
  assert tbl.dtype == jnp.bfloat16
  ids = jnp.asarray(np.random.RandomState(0).randint(0, 512, 64),
                    jnp.int32)
  from hybridbackend_tpu.embedding import lookup
  emb = lookup(tbl, ids, cfg)
  assert emb.dtype == jnp.bfloat16
  st = init_adagrad_state(tbl, 0.1)
  t2, s2 = sparse_adagrad_apply(tbl, st, ids,
                                jnp.ones((64, 16), jnp.float32), cfg,
                                0.1)
  assert t2.dtype == jnp.bfloat16 and s2.acc[0].dtype == jnp.bfloat16
  moved = np.abs(np.asarray(t2, np.float32)
                 - np.asarray(tbl, np.float32))
  touched = sorted(set(np.asarray(ids).tolist()))
  assert (moved[touched].sum(axis=1) > 0).all()
  untouched = sorted(set(range(512)) - set(touched))
  assert moved[untouched].sum() == 0


def test_adam_out_of_vocab_ids_do_not_decay_rows():
  """LazyAdam updates moments on PRESENCE, so an out-of-vocab positive
  id that mapped onto a real (mixed/padding) row would silently decay
  that row's moments even with a zero gradient — the update entry
  points enforce the same logical-id validity as lookup."""
  from hybridbackend_tpu.embedding.sparse_update import (
      init_adam_state, sparse_adam_apply)
  cfg = TableConfig('av', 300, 8, shuffle_ids=True, sharded=False)
  tbl = create_table(cfg, jax.random.PRNGKey(0))
  st = init_adam_state(tbl)
  m0 = np.asarray(st.acc[0]) + 1.0    # nonzero moments everywhere
  st = type(st)(acc=(jnp.asarray(m0), st.acc[1]))
  bad = jnp.asarray([300, 400, -1, 5000], jnp.int32)
  t2, s2 = sparse_adam_apply(tbl, st, bad, jnp.zeros((4, 8)), cfg,
                             0.1, step=1)
  np.testing.assert_array_equal(np.asarray(t2), np.asarray(tbl))
  np.testing.assert_array_equal(np.asarray(s2.acc[0]), m0)
