"""Tests that need an NVIDIA GPU; they skip where JAX finds none.

Run them on the card with:
  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import jax
import numpy as np
import pytest

import hybridbackend_tpu as hb
from hybridbackend_tpu.framework.context import Context, build_mesh
from hybridbackend_tpu.utils.flagship import (
    FlagshipConfig, compare, make_batches, reference_steps)

TINY = FlagshipConfig(tables=3, vocab=500, dim=16, dense=2, mlp=(64, 32, 1),
                      batch=256)


@pytest.fixture
def gpu():
  try:
    devices = jax.devices('gpu')
  except RuntimeError:
    devices = []
  if not devices:
    pytest.skip('JAX finds no GPU here')
  return devices


@pytest.mark.gpu
def test_flagship_matches_reference_on_gpu(gpu):
  """The flagship trainer, compiled for the card, against the plain
  reference under 'highest' (f32 on both sides; only sum order
  differs)."""
  from test_flagship import BOUNDS, STEPS, _program
  ctx = Context(build_mesh(gpu[:1]))
  batches = make_batches(TINY, STEPS, seed=4)
  with hb.context_scope(ctx), jax.default_matmul_precision('highest'):
    init, rec = _program(TINY, ctx, batches)
    ref_losses, ref = reference_steps(init, batches[:STEPS], TINY)
  (table,) = rec.trainer.state.tables.values()
  assert table.devices() == {gpu[0]}
  dev = compare(rec.losses, rec.state, ref_losses, ref, init,
                batches[:STEPS])
  assert dev['untouched_moved'] == 0, dev
  for k, b in BOUNDS.items():
    assert dev[k] <= b, (k, dev)


@pytest.mark.gpu
def test_sparse_adagrad_on_gpu(gpu):
  """Duplicate, negative and out-of-vocabulary ids through the XLA
  update as compiled for the card."""
  from test_sparse_update_reference import _ids_grads, _reference
  from hybridbackend_tpu.embedding import TableConfig, create_table
  from hybridbackend_tpu.embedding.sparse_update import (
      init_adagrad_state, sparse_adagrad_apply)
  ctx = Context(build_mesh(gpu[:1]))
  with hb.context_scope(ctx):
    cfg = TableConfig('g', 96, 16)
    table = create_table(cfg, jax.random.PRNGKey(0))
    state = init_adagrad_state(table, 0.1)
    ids, g = _ids_grads(seed=5)
    got_t, got_s = jax.jit(
        lambda t, s, i, d: sparse_adagrad_apply(t, s, i, d, cfg, 0.1)
    )(table, state, ids, g)
  want_t, (want_a,) = _reference('adagrad', np.asarray(table),
                                 [np.full((96, 16), 0.1, np.float32)],
                                 ids, g, 0.1)
  np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(np.asarray(got_s.acc[0]), want_a, rtol=1e-5,
                             atol=1e-6)
