"""Column-sharded (dim-axis) embedding tables.

BASELINE config #4: large-dim tables sharded along the embedding dim —
every device holds all rows of its dim slice. Lookup = all_gather ids →
local slice gather → tiled all_to_all; updates run the inverse exchange.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hybridbackend_tpu as hb
from hybridbackend_tpu.embedding import TableConfig, create_table, lookup
from hybridbackend_tpu.embedding.sparse_update import (
    init_adagrad_state, sparse_adagrad_apply, sparse_sgd_apply)

V, D, B = 500, 32, 64


@pytest.fixture
def setup():
  ctx = hb.Context.get()
  cfg = TableConfig('c', V, D, partition='column', sharded=True)
  tbl = create_table(cfg, jax.random.PRNGKey(0), ctx)
  return ctx, cfg, tbl


def test_sharding_is_dim_axis(setup):
  ctx, cfg, tbl = setup
  assert tbl.shape == (V, D)
  spec = tbl.sharding.spec
  assert spec[0] is None and spec[1] is not None


def test_lookup_matches_host_gather(setup):
  ctx, cfg, tbl = setup
  host = np.asarray(tbl)
  ids = np.random.RandomState(0).randint(-5, V + 5, B).astype(np.int32)
  out = np.asarray(lookup(tbl, jnp.asarray(ids), cfg, ctx=ctx))
  want = np.where(((ids >= 0) & (ids < V))[:, None],
                  host[np.clip(ids, 0, V - 1)], 0)
  np.testing.assert_allclose(out, want, atol=1e-5)


def test_grad_rows(setup):
  ctx, cfg, tbl = setup
  ids = np.random.RandomState(1).randint(0, V, B).astype(np.int32)

  def loss(t):
    return lookup(t, jnp.asarray(ids), cfg, ctx=ctx).sum()

  g = np.asarray(jax.grad(loss)(tbl))
  assert set(np.nonzero(np.abs(g).sum(-1))[0].tolist()) == set(ids.tolist())


def test_sparse_adagrad(setup):
  ctx, cfg, tbl = setup
  host = np.asarray(tbl)
  rng = np.random.RandomState(2)
  ids = rng.randint(0, V, B).astype(np.int32)
  demb = rng.randn(B, D).astype(np.float32)
  state = init_adagrad_state(tbl, 0.1)
  t2, s2 = sparse_adagrad_apply(tbl, state, jnp.asarray(ids),
                                jnp.asarray(demb), cfg, 0.1)
  wt = host.copy()
  wa = np.full((V, D), 0.1, np.float32)
  for r in np.unique(ids):
    g = demb[ids == r].sum(0)
    wa[r] += g * g
    wt[r] -= 0.1 * g / (np.sqrt(wa[r]) + 1e-7)
  np.testing.assert_allclose(np.asarray(t2), wt, atol=2e-4)
  np.testing.assert_allclose(np.asarray(s2.acc[0]), wa, atol=2e-3)
  assert t2.sharding.spec == tbl.sharding.spec


def test_dim_must_divide():
  cfg = TableConfig('bad', V, 12, partition='column', sharded=True)
  with pytest.raises(ValueError, match='divide evenly'):
    create_table(cfg, jax.random.PRNGKey(0))


def test_stack_groups_by_partition():
  from hybridbackend_tpu.embedding.stack import build_stacks
  cfgs = [TableConfig('a', 256, 32), TableConfig('b', 256, 32),
          TableConfig('c', 256, 32, partition='column', sharded=True)]
  stacks = build_stacks(cfgs)
  assert len(stacks) == 2
  by_partition = {s.stacked.partition: [c.name for c in s.configs]
                  for s in stacks}
  assert by_partition['row'] == ['a', 'b']
  assert by_partition['column'] == ['c']
