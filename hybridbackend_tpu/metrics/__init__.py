"""Globally exact distributed evaluation metrics.

A JAX re-design of the reference metrics
(``/root/reference/hybridbackend/tensorflow/metrics/``): ``auc``
allreduces a stacked TP/FN/TN/FP confusion matrix across workers
(``auc.py:130-186``), ``gauc`` computes per-group AUCs in a C++ kernel
and averages them weighted by group size (``gauc.py:32-71``,
``gauc.cc:25-148``), plus ``mean`` and ``accuracy``.

In JAX the metrics are pure accumulator pytrees updated by jitted
functions. Global exactness needs no explicit collective: updates run
under ``jit`` on globally-sharded arrays, so every ``jnp.sum`` is a
global sum (XLA inserts the reduction over the mesh) — the direct
analogue of the reference's confusion-matrix allreduce.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-7


# ---------------------------------------------------------------------------
# AUC (thresholded confusion matrix, reference metrics/auc.py)
# ---------------------------------------------------------------------------

class AUCState(NamedTuple):
  tp: jax.Array
  fp: jax.Array
  tn: jax.Array
  fn: jax.Array


def auc_init(num_thresholds: int = 200) -> AUCState:
  z = jnp.zeros((num_thresholds,), jnp.float32)
  return AUCState(z, z, z, z)


def _thresholds(num_thresholds: int) -> jnp.ndarray:
  # Reference/TF scheme: interior thresholds (i+1)/(T-1) with +/- eps edges.
  t = jnp.asarray(
      [(i + 1) * 1.0 / (num_thresholds - 1)
       for i in range(num_thresholds - 2)], jnp.float32)
  return jnp.concatenate([jnp.asarray([-_EPS], jnp.float32), t,
                          jnp.asarray([1.0 + _EPS], jnp.float32)])


def auc_update(state: AUCState, labels: jax.Array, predictions: jax.Array,
               weights: Optional[jax.Array] = None) -> AUCState:
  """Accumulate the confusion matrix; safe to call under jit on sharded
  global arrays (the sums are then globally exact)."""
  num_thresholds = state.tp.shape[0]
  thr = _thresholds(num_thresholds)
  labels = labels.reshape(-1).astype(jnp.float32)
  predictions = predictions.reshape(-1).astype(jnp.float32)
  if weights is None:
    w = jnp.ones_like(predictions)
  else:
    w = weights.reshape(-1).astype(jnp.float32)
  pred_pos = predictions[None, :] > thr[:, None]        # [T, N]
  label_pos = (labels > 0)[None, :]
  wN = w[None, :]
  tp = jnp.sum(jnp.where(pred_pos & label_pos, wN, 0.0), axis=1)
  fp = jnp.sum(jnp.where(pred_pos & ~label_pos, wN, 0.0), axis=1)
  tn = jnp.sum(jnp.where(~pred_pos & ~label_pos, wN, 0.0), axis=1)
  fn = jnp.sum(jnp.where(~pred_pos & label_pos, wN, 0.0), axis=1)
  return AUCState(state.tp + tp, state.fp + fp, state.tn + tn,
                  state.fn + fn)


def auc_result(state: AUCState, curve: str = 'ROC') -> jax.Array:
  """Riemann-sum AUC from the accumulated confusion matrix."""
  if curve == 'ROC':
    x = state.fp / jnp.maximum(state.fp + state.tn, _EPS)   # fpr
    y = state.tp / jnp.maximum(state.tp + state.fn, _EPS)   # tpr (recall)
  elif curve == 'PR':
    x = state.tp / jnp.maximum(state.tp + state.fn, _EPS)   # recall
    y = state.tp / jnp.maximum(state.tp + state.fp, _EPS)   # precision
  else:
    raise ValueError(f'Unknown curve: {curve}')
  # Thresholds ascend → x descends; integrate |dx| * mean(y).
  return jnp.sum((x[:-1] - x[1:]) * (y[:-1] + y[1:]) / 2.0)


# ---------------------------------------------------------------------------
# Streaming mean / accuracy (reference metrics/mean.py, accuracy.py)
# ---------------------------------------------------------------------------

class MeanState(NamedTuple):
  total: jax.Array
  count: jax.Array


def mean_init() -> MeanState:
  return MeanState(jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))


def mean_update(state: MeanState, values: jax.Array,
                weights: Optional[jax.Array] = None) -> MeanState:
  values = values.reshape(-1).astype(jnp.float32)
  if weights is None:
    w = jnp.ones_like(values)
  else:
    w = jnp.broadcast_to(weights.astype(jnp.float32).reshape(-1),
                         values.shape)
  return MeanState(state.total + jnp.sum(values * w),
                   state.count + jnp.sum(w))


def mean_result(state: MeanState) -> jax.Array:
  return state.total / jnp.maximum(state.count, _EPS)


def accuracy_update(state: MeanState, labels: jax.Array,
                    predictions: jax.Array,
                    weights: Optional[jax.Array] = None) -> MeanState:
  correct = (labels.reshape(-1) == predictions.reshape(-1))
  return mean_update(state, correct.astype(jnp.float32), weights)


accuracy_init = mean_init
accuracy_result = mean_result


# ---------------------------------------------------------------------------
# GAUC (grouped AUC, reference metrics/gauc.cc ComputeGauc)
# ---------------------------------------------------------------------------

def gauc_batch(labels: jax.Array, predictions: jax.Array,
               indicators: jax.Array,
               skip_boundary_groups: bool = True,
               sort_groups: bool = False
               ) -> Tuple[jax.Array, jax.Array]:
  """Per-batch grouped AUC contribution ``(sum aucs*counts, sum counts)``.

  Vectorized translation of the reference kernel (``gauc.cc:38-148``):
  groups are *contiguous runs* of equal ``indicators``; within each group
  examples are sorted by prediction and the trapezoid
  ``Σ (fp2-fp1)(tp2+tp1)`` accumulated with soft labels; the group AUC is
  ``1 - acc/(2·tp·fp)``. Groups that are all-positive or all-negative are
  skipped, as are (optionally) the first and last group of the batch —
  they may be truncated at batch boundaries, exactly like the reference's
  ``first`` flag / incomplete-final-run handling.

  ``sort_groups=True`` pre-sorts the batch by indicator so gAUC works on
  shuffled batches (otherwise every group must already be a contiguous
  run, as the reference kernel requires — with shuffled data every run
  is a singleton and the result is 0/0).
  """
  n = labels.shape[0]
  labels = labels.reshape(-1).astype(jnp.float32)
  predictions = predictions.reshape(-1).astype(jnp.float32)
  indicators = indicators.reshape(-1)
  if sort_groups:
    order0 = jnp.argsort(indicators, stable=True)
    labels, predictions = labels[order0], predictions[order0]
    indicators = indicators[order0]
    skip_boundary_groups = False  # groups are complete after sorting

  changed = jnp.concatenate([
      jnp.zeros((1,), jnp.int32),
      (indicators[1:] != indicators[:-1]).astype(jnp.int32)])
  gid = jnp.cumsum(changed)                       # dense group ids, sorted
  num_groups = gid[-1] + 1

  # Sort by (group, prediction) ascending.
  order = jnp.lexsort((predictions, gid))
  g = gid[order]
  lab = labels[order]
  click = lab
  nonclick = 1.0 - lab

  # Per-group cumulative sums: global cumsum minus group-start offset.
  ctp = jnp.cumsum(click)
  cfp = jnp.cumsum(nonclick)
  first_of_group = jnp.concatenate([
      jnp.ones((1,), jnp.bool_), g[1:] != g[:-1]])
  # offset value at group start (cumsum before the group began)
  start_ctp = jnp.where(first_of_group, ctp - click, 0.0)
  start_cfp = jnp.where(first_of_group, cfp - nonclick, 0.0)
  # broadcast group-start offsets to members via cumulative max of a
  # monotone key (gid is sorted, so segment ops work):
  seg_start_ctp = jax.ops.segment_max(
      jnp.where(first_of_group, start_ctp, -jnp.inf), g, num_segments=n)
  seg_start_cfp = jax.ops.segment_max(
      jnp.where(first_of_group, start_cfp, -jnp.inf), g, num_segments=n)
  tp2 = ctp - seg_start_ctp[g]
  fp2 = cfp - seg_start_cfp[g]
  contrib = nonclick * (2.0 * tp2 - click)        # (fp2-fp1)(tp2+tp1)

  auc_acc = jax.ops.segment_sum(contrib, g, num_segments=n)
  tp_g = jax.ops.segment_sum(click, g, num_segments=n)
  fp_g = jax.ops.segment_sum(nonclick, g, num_segments=n)
  size_g = jax.ops.segment_sum(jnp.ones_like(click), g, num_segments=n)

  group_ids = jnp.arange(n)
  exists = group_ids < num_groups
  threshold = size_g - 1e-3
  valid = exists & (tp_g * fp_g > 0) & (tp_g <= threshold) & (
      fp_g <= threshold)
  if skip_boundary_groups:
    valid = valid & (group_ids != 0) & (group_ids != num_groups - 1)
  auc_g = 1.0 - auc_acc / jnp.maximum(2.0 * tp_g * fp_g, _EPS)
  vw = jnp.where(valid, size_g, 0.0)
  return jnp.sum(auc_g * vw), jnp.sum(vw)


def gauc_update(state: MeanState, labels: jax.Array,
                predictions: jax.Array, indicators: jax.Array,
                skip_boundary_groups: bool = True,
                sort_groups: bool = False) -> MeanState:
  num, den = gauc_batch(labels, predictions, indicators,
                        skip_boundary_groups, sort_groups=sort_groups)
  return MeanState(state.total + num, state.count + den)


gauc_init = mean_init
gauc_result = mean_result


__all__ = [
    'AUCState', 'auc_init', 'auc_update', 'auc_result',
    'MeanState', 'mean_init', 'mean_update', 'mean_result',
    'accuracy_init', 'accuracy_update', 'accuracy_result',
    'gauc_init', 'gauc_batch', 'gauc_update', 'gauc_result',
]
