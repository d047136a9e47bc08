"""The flagship stacked-DCNv2 trainer and a plain ``jax.numpy`` reference.

The flagship is the model the benchmarks measure: 26 categorical
features, each with its own ``[100_000, 16]`` float32 table, 13 dense
features, a DCNv2 cross layer and the tower ``[1024, 512, 256, 1]``,
global batch 8192, row-sparse Adagrad on the tables and Adam on the
tower. :func:`build_trainer` builds it through ``hb.SparseTrainer``.

:func:`reference_steps` is an independent implementation of the same
training semantics: dense tables read with ``jnp.take``, the cross layer
and MLP written out, ``jax.grad`` over everything, and the Adagrad and
Adam formulas applied densely. It imports nothing from this package, so
agreement between the two is evidence about the program, not about code
they share. :func:`compare` measures the agreement.

Batches are numpy arrays made from a seed. Ids follow a Zipf law over a
per-table permutation of the vocabulary, as hashed categorical features
do, so hot rows take many duplicate updates per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
  tables: int = 26
  vocab: int = 100_000
  dim: int = 16
  dense: int = 13
  mlp: Tuple[int, ...] = (1024, 512, 256, 1)
  batch: int = 8192
  table_lr: float = 0.05
  adagrad_init: float = 0.1
  adagrad_eps: float = 1e-7      # sparse_adagrad_apply's default
  dense_lr: float = 1e-3
  zipf: float = 1.05

  @property
  def table_names(self) -> List[str]:
    return [f'c{i}' for i in range(self.tables)]

  @property
  def dense_names(self) -> List[str]:
    return [f'i{j}' for j in range(self.dense)]


def make_batches(cfg: FlagshipConfig, n: int, seed: int
                 ) -> List[Dict[str, np.ndarray]]:
  """``n`` host batches: Zipf ids, uniform dense features, and labels
  drawn from a fixed logistic function of both (so AUC can move)."""
  rng = np.random.RandomState(seed)
  ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
  cdf = np.cumsum(ranks ** -cfg.zipf)
  cdf /= cdf[-1]
  perms = [rng.permutation(cfg.vocab).astype(np.int32)
           for _ in range(cfg.tables)]
  id_bias = rng.randn(cfg.vocab).astype(np.float32)
  dense_w = rng.randn(cfg.dense).astype(np.float32)
  out = []
  for _ in range(n):
    b = {}
    for t, name in enumerate(cfg.table_names):
      r = np.searchsorted(cdf, rng.rand(cfg.batch))
      b[name] = perms[t][np.minimum(r, cfg.vocab - 1)]
    dense = rng.rand(cfg.batch, cfg.dense).astype(np.float32)
    for j, name in enumerate(cfg.dense_names):
      b[name] = dense[:, j]
    logit = (dense - 0.5) @ dense_w + id_bias[b['c0']]
    b['label'] = (rng.rand(cfg.batch)
                  < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    out.append(b)
  return out


# ---------------------------------------------------------------------------
# The program: hb.SparseTrainer.
# ---------------------------------------------------------------------------

def _bce(preds, y):
  p = jnp.clip(preds, 1e-6, 1 - 1e-6)
  return -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))


def build_trainer(cfg: FlagshipConfig, seed: int, ctx=None):
  """The flagship through the public entry point, from ``seed``."""
  import optax
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.models import (
      EmbeddingSpec, StackedFeatureExtractor, stacked_dcn_v2_apply,
      stacked_dcn_v2_init)

  specs = [EmbeddingSpec(TableConfig(name, cfg.vocab, cfg.dim))
           for name in cfg.table_names]
  fx = StackedFeatureExtractor(specs, dense_columns=cfg.dense_names,
                               ctx=ctx)
  k_tab, k_net = jax.random.split(jax.random.PRNGKey(seed))
  net = stacked_dcn_v2_init(
      k_net, [cfg.dim] * cfg.tables + [1] * cfg.dense, list(cfg.mlp))

  def model_loss(dense_params, emb_f, dense_f, batch):
    preds = stacked_dcn_v2_apply(dense_params, emb_f + dense_f)
    pel = _bce(preds, batch['label'])
    return jnp.mean(pel), {'preds': preds, 'per_example_loss': pel}

  return hb.SparseTrainer(
      fx, model_loss, net, dense_optimizer=optax.adam(cfg.dense_lr),
      table_lr=cfg.table_lr, adagrad_init=cfg.adagrad_init, ctx=ctx,
      rng=k_tab, model_dir=None)


def snapshot(trainer, names: Sequence[str]) -> Dict[str, Any]:
  """Host copy of a trainer's state in the reference's layout: the
  tower, and the member tables ``names`` with their Adagrad
  accumulators (``{name: [vocab, dim]}``), whatever the physical layout
  (stacking, lane packing, row sharding)."""
  from hybridbackend_tpu.embedding.stack import member_tables
  fx = trainer._fx
  state = trainer.state
  tables, accs = {}, {}
  for stack in fx.stacks:
    want = [c for c in stack.configs if c.name in names]
    if not want:
      continue
    sname = stack.stacked.name
    t = member_tables(stack, state.tables[sname])
    a = member_tables(stack, state.table_opt[sname].acc[0])
    for c in want:
      tables[c.name] = np.array(t[c.name][:c.vocab_size])
      accs[c.name] = np.array(a[c.name][:c.vocab_size])
  return {'dense': jax.tree_util.tree_map(np.array, state.dense),
          'tables': tables, 'acc': accs}


# ---------------------------------------------------------------------------
# The plain reference. Imports nothing from hybridbackend_tpu.
# ---------------------------------------------------------------------------

def reference_forward(dense, tables, batch, cfg: FlagshipConfig):
  """Lookup, cross layer ``x * relu(x W + b) + x``, ReLU MLP, sigmoid."""
  x = jnp.concatenate(
      [jnp.take(tables[n], batch[n], axis=0) for n in cfg.table_names]
      + [batch[n][:, None] for n in cfg.dense_names], axis=-1)
  c = dense['cross']
  x = x * jax.nn.relu(x @ c['w'] + c['b']) + x
  layers = dense['mlp']
  for layer in layers[:-1]:
    x = jax.nn.relu(x @ layer['w'] + layer['b'])
  logit = x @ layers[-1]['w'] + layers[-1]['b']
  return jax.nn.sigmoid(logit)[:, 0]


def reference_loss(dense, tables, batch, cfg: FlagshipConfig):
  p = jnp.clip(reference_forward(dense, tables, batch, cfg),
               1e-6, 1 - 1e-6)
  y = batch['label']
  return -jnp.mean(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))


def reference_steps(init: Dict[str, Any], batches, cfg: FlagshipConfig
                    ) -> Tuple[List[float], Dict[str, Any]]:
  """Train from ``init`` (a full :func:`snapshot`, every table) on
  ``batches`` with dense Adagrad on the tables and Adam on the tower.

  Returns the per-step losses and the final state in snapshot layout.
  Runs under whatever ``jax.default_matmul_precision`` is in effect.
  """
  b1, b2, eps_adam = 0.9, 0.999, 1e-8

  @jax.jit
  def step(t, dense, tables, accs, m, v, batch):
    loss, (gd, gt) = jax.value_and_grad(
        reference_loss, argnums=(0, 1))(dense, tables, batch, cfg)
    accs = {n: accs[n] + gt[n] * gt[n] for n in tables}
    tables = {n: tables[n] - cfg.table_lr * gt[n]
              / (jnp.sqrt(accs[n]) + cfg.adagrad_eps) for n in tables}
    m = jax.tree_util.tree_map(lambda a, g: b1 * a + (1 - b1) * g, m, gd)
    v = jax.tree_util.tree_map(lambda a, g: b2 * a + (1 - b2) * g * g,
                               v, gd)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    dense = jax.tree_util.tree_map(
        lambda p, mm, vv: p - cfg.dense_lr * (mm / bc1)
        / (jnp.sqrt(vv / bc2) + eps_adam), dense, m, v)
    return loss, dense, tables, accs, m, v

  dense = jax.tree_util.tree_map(jnp.asarray, init['dense'])
  tables = {n: jnp.asarray(a) for n, a in init['tables'].items()}
  accs = {n: jnp.asarray(a) for n, a in init['acc'].items()}
  m = jax.tree_util.tree_map(jnp.zeros_like, dense)
  v = jax.tree_util.tree_map(jnp.zeros_like, dense)
  losses = []
  for i, b in enumerate(batches):
    batch = {k: jnp.asarray(a) for k, a in b.items()}
    loss, dense, tables, accs, m, v = step(
        jnp.float32(i + 1), dense, tables, accs, m, v, batch)
    losses.append(float(loss))
  return losses, {
      'dense': jax.tree_util.tree_map(np.asarray, dense),
      'tables': {n: np.asarray(a) for n, a in tables.items()},
      'acc': {n: np.asarray(a) for n, a in accs.items()}}


def compare(losses: Sequence[float], state: Dict[str, Any],
            ref_losses: Sequence[float], ref: Dict[str, Any],
            init: Dict[str, Any], batches) -> Dict[str, float]:
  """Largest deviations of the program from the reference.

  ``loss_rel``: per-step loss, relative. ``table_abs`` / ``acc_abs``:
  the touched rows of the tables in ``state`` and their accumulators.
  ``untouched_moved``: untouched rows of those tables that differ from
  ``init`` at all (the update must be row-sparse).
  """
  lr = np.abs(np.asarray(losses) - np.asarray(ref_losses)) / np.maximum(
      np.abs(np.asarray(ref_losses)), 1e-12)
  out = {'loss_rel': float(lr.max()), 'table_abs': 0.0, 'acc_abs': 0.0,
         'untouched_moved': 0.0}
  for name, got in state['tables'].items():
    touched = np.zeros(got.shape[0], bool)
    for b in batches:
      touched[b[name]] = True
    out['table_abs'] = max(out['table_abs'], float(
        np.abs(got[touched] - ref['tables'][name][touched]).max()))
    out['acc_abs'] = max(out['acc_abs'], float(
        np.abs(state['acc'][name][touched]
               - ref['acc'][name][touched]).max()))
    out['untouched_moved'] += float(np.sum(np.any(
        got[~touched] != init['tables'][name][~touched], axis=-1)))
  return out


__all__ = ['FlagshipConfig', 'build_trainer', 'compare', 'make_batches',
           'reference_forward', 'reference_loss', 'reference_steps',
           'snapshot']
