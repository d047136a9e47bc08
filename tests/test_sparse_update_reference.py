"""The XLA row-sparse updates against a plain numpy reference.

One parametrised comparison over optimizer (SGD, Adagrad, LazyAdam),
table layout (replicated, row-sharded through either gradient exchange,
column-sharded, lane-packed) and learning rate (Python float or traced
under jit), with duplicate, negative and out-of-vocabulary ids in every
batch. Invalid ids must leave every row and slot untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hybridbackend_tpu as hb
from hybridbackend_tpu.embedding import TableConfig, create_table
from hybridbackend_tpu.embedding.sparse_update import (
    init_adagrad_state, init_adam_state, sparse_adagrad_apply,
    sparse_adam_apply, sparse_sgd_apply)

VOCAB, DIM, BATCH = 96, 16, 64
LR, STEP = 0.1, 2

LAYOUTS = {
    'replicated': dict(sharded=False),
    'row_alltoall': dict(sharded=True),
    'row_allgather': dict(sharded=True),
    'column': dict(sharded=True, partition='column'),
    'packed': dict(sharded=False, lane_pack=True),
}
CASES = [(opt, layout) for opt in ('sgd', 'adagrad', 'adam')
         for layout in LAYOUTS
         if not (opt == 'adam' and layout == 'packed')]


def _ids_grads(seed):
  rng = np.random.RandomState(seed)
  ids = rng.randint(0, 12, BATCH)                # heavy duplication
  ids[::9] = -1                                  # padding lanes
  ids[5::13] = VOCAB + 7                         # out of vocabulary
  ids[7] = ids[8] = 3                            # a sure duplicate
  return ids.astype(np.int32), rng.randn(BATCH, DIM).astype(np.float32)


def _reference(opt, table, slots, ids, g, lr):
  """Per-row totals of the valid ids, then the textbook update."""
  table = table.copy()
  slots = [s.copy() for s in slots]
  valid = (ids >= 0) & (ids < VOCAB)
  for r in np.unique(ids[valid]):
    gs = g[valid & (ids == r)].sum(0)
    if opt == 'sgd':
      table[r] -= lr * gs
    elif opt == 'adagrad':
      slots[0][r] += gs * gs
      table[r] -= lr * gs / (np.sqrt(slots[0][r]) + 1e-7)
    else:
      m, v = slots
      m[r] = 0.9 * m[r] + 0.1 * gs
      v[r] = 0.999 * v[r] + 0.001 * gs * gs
      mh, vh = m[r] / (1 - 0.9 ** STEP), v[r] / (1 - 0.999 ** STEP)
      table[r] -= lr * mh / (np.sqrt(vh) + 1e-8)
  return table, slots


def _host_rows(cfg, arr):
  """Logical [VOCAB, DIM] view of a physical (maybe packed) array."""
  return np.asarray(arr).reshape(-1, DIM)[:VOCAB]


@pytest.mark.parametrize('traced_lr', [False, True], ids=['lr', 'traced_lr'])
@pytest.mark.parametrize('opt,layout', CASES)
def test_update_matches_numpy(opt, layout, traced_lr):
  cfg = TableConfig('u', VOCAB, DIM, **LAYOUTS[layout])
  table = create_table(cfg, jax.random.PRNGKey(0))
  if layout == 'packed':
    assert table.shape == (VOCAB // 8, 128)
  if opt == 'adagrad':
    state = init_adagrad_state(table, 0.1)
  elif opt == 'adam':
    state = init_adam_state(table)
    # Nonzero moments, so that decay of an untouched row would show.
    state = type(state)(acc=tuple(s + 0.5 for s in state.acc))
  ids, g = _ids_grads(seed=len(opt) + len(layout))

  def apply(t, s, i, d, lr):
    if opt == 'sgd':
      return sparse_sgd_apply(t, i, d, cfg, lr), None
    if opt == 'adagrad':
      return sparse_adagrad_apply(t, s, i, d, cfg, lr)
    return sparse_adam_apply(t, s, i, d, cfg, lr, step=STEP)

  exchange = 'allgather' if layout == 'row_allgather' else 'alltoall'
  with hb.scope(emb_update_exchange=exchange):
    args = (table, None if opt == 'sgd' else state,
            jnp.asarray(ids), jnp.asarray(g))
    if traced_lr:
      got_t, got_s = jax.jit(apply)(*args, jnp.float32(LR))
    else:
      got_t, got_s = apply(*args, LR)

  slots0 = [] if opt == 'sgd' else [_host_rows(cfg, a) for a in state.acc]
  want_t, want_s = _reference(opt, _host_rows(cfg, table), slots0, ids, g,
                              LR)
  np.testing.assert_allclose(_host_rows(cfg, got_t), want_t,
                             rtol=1e-5, atol=1e-6)
  for got, want in zip(() if got_s is None else got_s.acc, want_s):
    np.testing.assert_allclose(_host_rows(cfg, got), want,
                               rtol=1e-5, atol=1e-6)
  assert got_t.shape == table.shape
  assert got_t.sharding.spec == table.sharding.spec
