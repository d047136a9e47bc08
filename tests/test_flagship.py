"""The flagship helper behind ``chip_smoke.py``: the program against its
plain reference at a tiny width on the CPU mesh, and the comparison's
power to catch a wrong update."""

import dataclasses

import jax
import numpy as np
import pytest

import hybridbackend_tpu as hb
from hybridbackend_tpu.framework.context import Context, build_mesh
from hybridbackend_tpu.training.hooks import Hook
from hybridbackend_tpu.utils.flagship import (
    FlagshipConfig, build_trainer, compare, make_batches, reference_steps,
    snapshot)

TINY = FlagshipConfig(tables=3, vocab=200, dim=8, dense=2, mlp=(16, 8, 1),
                      batch=64)
STEPS = 3
# f32 on the CPU on both sides; only the order of sums differs.
BOUNDS = {'loss_rel': 1e-5, 'table_abs': 1e-6, 'acc_abs': 1e-6}


class _Record(Hook):

  def __init__(self, trainer, at):
    self.trainer, self.at = trainer, at
    self.losses, self.state = [], None

  def after_step(self, step, metrics):
    self.losses.append(float(metrics['loss']))
    if len(self.losses) == self.at:
      self.state = snapshot(self.trainer, ('c0', 'c2'))


def _program(cfg, ctx, batches):
  tr = build_trainer(cfg, seed=0, ctx=ctx)
  init = snapshot(tr, cfg.table_names)
  rec = _Record(tr, STEPS)
  tr.train(iter(batches[:STEPS]), hooks=[rec])
  return init, rec


@pytest.mark.parametrize('devices,strategy', [
    (1, 'allgather'), (8, 'allgather'), (8, 'alltoall')])
def test_program_matches_reference(devices, strategy):
  ctx = Context(build_mesh(jax.devices()[:devices]))
  batches = make_batches(TINY, STEPS, seed=1)
  with hb.context_scope(ctx), hb.scope(emb_lookup_strategy=strategy):
    init, rec = _program(TINY, ctx, batches)
  (name, table), = [(n, t) for n, t in rec.trainer.state.tables.items()]
  assert len(table.sharding.device_set) == devices
  ref_losses, ref = reference_steps(init, batches[:STEPS], TINY)
  dev = compare(rec.losses, rec.state, ref_losses, ref, init,
                batches[:STEPS])
  assert dev['untouched_moved'] == 0, dev
  for k, b in BOUNDS.items():
    assert dev[k] <= b, (k, dev)


def test_comparison_catches_a_wrong_table_update():
  """A reference with another table learning rate must fail the same
  bounds: the comparison is not vacuous at this width."""
  ctx = Context(build_mesh(jax.devices()[:1]))
  batches = make_batches(TINY, STEPS, seed=2)
  with hb.context_scope(ctx):
    init, rec = _program(TINY, ctx, batches)
  wrong = dataclasses.replace(TINY, table_lr=TINY.table_lr * 1.01)
  ref_losses, ref = reference_steps(init, batches[:STEPS], wrong)
  dev = compare(rec.losses, rec.state, ref_losses, ref, init,
                batches[:STEPS])
  assert dev['table_abs'] > BOUNDS['table_abs'], dev


def test_batches_are_seeded_skewed_and_labelled():
  a = make_batches(TINY, 2, seed=3)
  b = make_batches(TINY, 2, seed=3)
  for x, y in zip(a, b):
    assert x.keys() == y.keys()
    for k in x:
      np.testing.assert_array_equal(x[k], y[k])
  ids = a[0]['c0']
  assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < 200
  # Zipf ids: the hottest id takes far more than a uniform share.
  assert np.bincount(ids).max() > 4 * TINY.batch / TINY.vocab
  assert set(np.unique(a[0]['label'])) <= {0.0, 1.0}
  assert a[0]['i1'].shape == (TINY.batch,)
