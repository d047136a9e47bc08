"""High-level Trainer: train / evaluate / train_and_evaluate / export.

A JAX re-design of the reference's wrapped Estimator
(``/root/reference/hybridbackend/tensorflow/estimator/estimator.py:73-577``)
and in-training ``EvaluationHook``
(``training/evaluation.py:111-327``). Instead of wrapping a TF Estimator
with monkey-patched RunConfig/model_fn, the Trainer owns the explicit
pieces: a loss function, an optax optimizer, the TrainState, checkpoint
management, hooks, sync-replica iteration, and a jitted eval loop that
reuses the training params (the reference's same-session eval graph).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

import hybridbackend_tpu.metrics as hbm
from hybridbackend_tpu.data.prefetch import DeviceIterator
from hybridbackend_tpu.data.sync import SyncReplicasIterator
from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.training.checkpoint import CheckpointManager
from hybridbackend_tpu.training.hooks import Hook, LoggingHook, StepStatHook
from hybridbackend_tpu.training.train import (
    TrainState, make_eval_step, make_train_step)

LOG = logging.getLogger('hybridbackend_tpu')


import functools


@functools.partial(jax.jit,
                   static_argnames=('has_pel', 'has_valid', 'has_group'))
def _metrics_step(auc_s, loss_s, gauc_s, labels, preds, pel, loss, valid,
                  ind, *, has_pel, has_valid, has_group):
  """One jitted program for a whole batch's metric updates.

  Eagerly dispatching each jnp op of auc/mean/gauc separately would run
  dozens of tiny multi-process programs per eval batch (each with its
  own compile and its own collectives on the submission stream); fusing
  them keeps eval fast and gives every process ONE identical program to
  submit per batch — the same single-submission discipline as the train
  step."""
  w = valid if has_valid else None
  auc_s = hbm.auc_update(auc_s, labels, preds, weights=w)
  if has_pel:
    loss_s = hbm.mean_update(loss_s, pel, w)
  elif has_valid:
    loss_s = hbm.mean_update(loss_s, loss[None], jnp.sum(valid)[None])
  else:
    loss_s = hbm.mean_update(
        loss_s, loss[None],
        jnp.asarray([labels.shape[0]], jnp.float32))
  if has_group:
    if has_valid:
      # Padding rows must not merge into a real group: give them a
      # sentinel indicator below every real one — their group is
      # all-negative (labels are zero) and gauc skips it. Signed cast
      # so the sentinel cannot wrap into a real id.
      ind = ind.astype(jnp.int64)
      ind = jnp.where(valid > 0, ind, jnp.min(ind) - 1)
    # sort_groups: eval batches are not guaranteed group-contiguous.
    gauc_s = hbm.gauc_update(gauc_s, labels, preds, ind,
                             sort_groups=True)
  return auc_s, loss_s, gauc_s

OPTIONS.register('save_checkpoint_steps', 0, env='HB_SAVE_CHECKPOINT_STEPS',
                 doc='Checkpoint every N steps (0 = only at end).')
OPTIONS.register('summary_steps', 100, env='HB_SUMMARY_STEPS',
                 doc='Write train-scalar TensorBoard summaries every N '
                     'steps into model_dir (0 disables). Eval results '
                     'are always summarized when a model_dir is set.')


def _host_mean(v) -> float:
  """Mean of a metric as a host float. Batch-sharded aux arrays (e.g.
  per-example losses) are not fully addressable in multi-process runs —
  average this process's local shards instead (equal-sized shards, so
  the local mean equals the global mean of what this process holds)."""
  if isinstance(v, jax.Array) and not (v.is_fully_replicated
                                       or v.is_fully_addressable):
    parts = [np.asarray(s.data) for s in v.addressable_shards]
    return float(np.mean([p.mean() for p in parts]))
  return float(np.asarray(v).mean())


class Trainer:
  """Owns the full training lifecycle for one model.

  Class attributes ``_host_transform`` / ``_eval_host_transform`` /
  ``_cache_runner`` are the cache-backed-table hook points (set by
  ``SparseTrainer(caches=...)``): host batches pass through the
  transform before device placement, and the runner's pending array
  effects are applied to the state before each step.

  Args:
    loss_fn: ``(params, batch) -> (scalar_loss, aux_dict)``. ``aux_dict``
      should include ``'preds'`` for the built-in eval metrics.
    params: initial parameter pytree (tables + dense net).
    optimizer: optax transformation; default Adagrad(0.1) on everything.
    model_dir: checkpoint/summary directory (restores latest on init).
    label_key: batch key with labels for the built-in binary-CTR eval.
  """

  _host_transform = None
  _eval_host_transform = None
  _cache_runner = None
  _model_dir: Optional[str] = None
  _summary = None

  def _get_summary_writer(self):
    """Chief-only lazy event writer into model_dir (reference
    Policy.Trigger / EvaluationHook summaries, ``hooks.py:36-160``,
    ``evaluation.py:111-327``)."""
    if self._model_dir is None or not self._ctx.is_chief:
      return None
    if self._summary is None:
      from hybridbackend_tpu.utils.summary import SummaryWriter
      self._summary = SummaryWriter(self._model_dir)
    return self._summary

  def __init__(self, loss_fn: Callable, params: Any,
               optimizer: Optional[optax.GradientTransformation] = None,
               model_dir: Optional[str] = None,
               ctx: Optional[Context] = None,
               label_key: str = 'label',
               group_key: Optional[str] = None):
    self._ctx = ctx or Context.get()
    self._loss_fn = loss_fn
    self._label_key = label_key
    self._group_key = group_key
    if optimizer is None:
      optimizer = optax.adagrad(0.1)
    self._optimizer = optimizer
    self.state = TrainState.create(params, optimizer, self._ctx)
    self._step_fn = make_train_step(loss_fn, optimizer, self._ctx,
                                    params_template=self.state.params)
    self._eval_fn = make_eval_step(
        lambda p, b: loss_fn(p, b), self._ctx)
    model_dir = model_dir or OPTIONS['model_dir']
    self._ckpt: Optional[CheckpointManager] = None
    if model_dir and model_dir != '.':
      self._model_dir = model_dir
      self._ckpt = CheckpointManager(model_dir)
      restored = self._ckpt.restore(self.state)
      if restored is not self.state:
        LOG.info('restored checkpoint at step %s',
                 int(np.asarray(restored.step)))
      self.state = restored

  @property
  def params(self):
    return self.state.params

  @property
  def global_step(self) -> int:
    return int(np.asarray(self.state.step))

  # -- training ------------------------------------------------------------

  def train(self, batches: Iterable[Dict[str, np.ndarray]],
            max_steps: Optional[int] = None,
            hooks: Sequence[Hook] = (),
            sync: bool = True,
            prefetch: bool = True,
            save_checkpoint_steps: Optional[int] = None,
            eval_every_n_steps: Optional[int] = None,
            eval_batches_fn: Optional[Callable[[], Iterable]] = None
            ) -> Dict[str, float]:
    """Run the training loop; returns the last step's metrics.

    ``eval_every_n_steps`` + ``eval_batches_fn`` give in-training eval
    (reference EvaluationHook): every N steps the Trainer runs a full
    evaluation pass on a fresh eval iterator and logs the results.
    """
    if save_checkpoint_steps is None:
      save_checkpoint_steps = int(OPTIONS['save_checkpoint_steps'])
    it: Iterator = iter(batches)
    sync_it = None
    if sync:
      it = sync_it = SyncReplicasIterator(it, ctx=self._ctx)
    if prefetch:
      it = DeviceIterator(it, ctx=self._ctx,
                          transform=self._host_transform)
    elif self._host_transform is not None:
      it = map(self._host_transform, it)
    hooks = list(hooks)
    if isinstance(it, DeviceIterator):
      for h in hooks:
        if isinstance(h, StepStatHook):
          h.set_input_iterator(it)  # input-stall attribution
    summary_steps = int(OPTIONS['summary_steps'])
    if summary_steps:
      writer = self._get_summary_writer()
      if writer is not None:
        from hybridbackend_tpu.training.hooks import SummaryHook
        hooks.append(SummaryHook(writer, every_n_steps=summary_steps))
    for h in hooks:
      h.begin()
    metrics: Dict[str, float] = {}
    steps_done = 0
    try:
      for batch in it:
        if max_steps is not None and steps_done >= max_steps:
          break
        step_no = self.global_step
        for h in hooks:
          h.before_step(step_no)
        if self._cache_runner is not None:
          self.state = self._cache_runner.apply_next(self.state)
        self.state, m = self._step_fn(self.state, batch)
        metrics = {k: v for k, v in m.items() if k != 'preds'}
        steps_done += 1
        step_no += 1
        for h in hooks:
          h.after_step(step_no, metrics)
        if (self._ckpt and save_checkpoint_steps
            and step_no % save_checkpoint_steps == 0):
          if self._cache_runner is not None:
            # Mid-train: the producer thread keeps planning, so take
            # the runner's atomic snapshot flush (undoes pending plans
            # on a metadata copy — no plan is consumed, no row is
            # written under a future owner).
            self._cache_runner.checkpoint_flush(self.state)
          self._ckpt.save(step_no, self.state)
        if (eval_every_n_steps and eval_batches_fn
            and step_no % eval_every_n_steps == 0):
          results = self.evaluate(eval_batches_fn())
          LOG.info('eval @ step %d: %s', step_no, results)
    finally:
      if isinstance(it, DeviceIterator):
        it.close()           # cascades to the wrapped sync iterator
      elif sync_it is not None:
        sync_it.close()      # bare sync mode (prefetch=False)
      if self._cache_runner is not None:
        # Prefetched batches may have been planned but never stepped;
        # apply their cache effects so slot metadata stays consistent
        # with the arrays.
        self.state = self._cache_runner.drain(self.state)
      for h in hooks:
        h.end(self.global_step)
      if self._ckpt:
        if self._cache_runner is not None:
          self._cache_runner.flush(self.state)
        self._ckpt.save(self.global_step, self.state)
    return {k: _host_mean(v) for k, v in metrics.items()}

  # -- evaluation ------------------------------------------------------------

  def evaluate(self, batches: Iterable[Dict[str, np.ndarray]],
               prefetch: bool = True) -> Dict[str, float]:
    """Full-pass evaluation with globally exact metrics (AUC, loss mean,
    and GAUC when ``group_key`` is set). Reference: separate eval graph
    over the same variables (``evaluation.py:111-327``).

    Exactness under uneven final batches: ``SyncReplicasIterator``
    (non-drop) pads every batch to a replica-consistent row count and
    attaches a ``_sync_valid`` weight column; every metric here consumes
    it as example weights, so padding rows contribute nothing — the
    result is bit-equal to a single-host pass over the concatenated
    data (reference contract: ``sync_replicas_dataset.cc:109-213`` +
    ``metrics/auc.py:169``). For an exact *loss* mean the loss function
    should either return ``aux['per_example_loss']`` (preferred) or
    itself weight by ``batch['_sync_valid']`` when present.
    """
    from hybridbackend_tpu.data.sync import SYNC_VALID_KEY
    it: Iterator = iter(batches)
    it = SyncReplicasIterator(it, drop_remainder=False, ctx=self._ctx)
    if prefetch:
      it = DeviceIterator(it, ctx=self._ctx,
                          transform=self._eval_host_transform)
    elif self._eval_host_transform is not None:
      it = map(self._eval_host_transform, it)
    auc_s = hbm.auc_init()
    loss_s = hbm.mean_init()
    gauc_s = hbm.gauc_init()
    zero = jnp.zeros((), jnp.float32)
    n = 0
    loss_exact = True
    for batch in it:
      labels = batch[self._label_key]
      if labels.shape[0] == 0:
        continue
      valid = batch.get(SYNC_VALID_KEY)
      loss, aux = self._eval_fn(self.params, batch)
      has_pel = 'per_example_loss' in aux
      if not has_pel and valid is not None and loss_exact:
        # Scalar-loss fallback weights by the valid count — exact only
        # when the loss fn itself masks by batch['_sync_valid'], which
        # the Trainer cannot verify. Exactness must not silently depend
        # on a docstring: warn once and flag the result.
        loss_exact = False
        LOG.warning(
            "evaluate: loss function returns only a scalar loss while "
            "batches carry '_sync_valid' padding weights; the reported "
            "'loss' averages over padding rows unless the loss fn masks "
            "by batch['_sync_valid']. Return aux['per_example_loss'] "
            "for an exact global mean. Results include loss_exact=0.0.")
      auc_s, loss_s, gauc_s = _metrics_step(
          auc_s, loss_s, gauc_s, labels, aux['preds'],
          aux.get('per_example_loss', zero), loss,
          zero if valid is None else valid,
          zero if self._group_key is None else batch[self._group_key],
          has_pel=has_pel, has_valid=valid is not None,
          has_group=self._group_key is not None)
      n += 1
    out = {
        'auc': float(hbm.auc_result(auc_s)),
        'loss': float(hbm.mean_result(loss_s)),
        'batches': float(n),
    }
    if not loss_exact:
      out['loss_exact'] = 0.0
    if self._group_key is not None:
      out['gauc'] = float(hbm.gauc_result(gauc_s))
    writer = self._get_summary_writer()
    if writer is not None:
      writer.scalars(self.global_step,
                     {'eval/' + k: v for k, v in out.items()
                      if k != 'batches'})
      writer.flush()
    return out

  def train_and_evaluate(self, train_batches_fn: Callable[[], Iterable],
                         eval_batches_fn: Callable[[], Iterable],
                         epochs: int = 1,
                         max_steps_per_epoch: Optional[int] = None,
                         hooks: Sequence[Hook] = ()) -> Dict[str, float]:
    """Alternate epochs of training with full evaluations
    (reference ``estimator.py:288-340``)."""
    results: Dict[str, float] = {}
    for ep in range(epochs):
      self.train(train_batches_fn(), max_steps=max_steps_per_epoch,
                 hooks=hooks)
      results = self.evaluate(eval_batches_fn())
      LOG.info('epoch %d eval: %s', ep, results)
    return results

  def predict(self, batches: Iterable[Dict[str, np.ndarray]],
              prefetch: bool = True) -> Iterator[np.ndarray]:
    """Yield per-batch predictions (reference ``estimator.py:511``)."""
    it: Iterator = iter(batches)
    if prefetch:
      it = DeviceIterator(it, ctx=self._ctx,
                          transform=self._eval_host_transform)
    elif self._eval_host_transform is not None:
      it = map(self._eval_host_transform, it)
    for batch in it:
      _, aux = self._eval_fn(self.params, batch)
      yield np.asarray(aux['preds'])

  # -- export ------------------------------------------------------------

  def export_saved_model(self, path: str, example_batch,
                         id_mappers=None, poly_batch: bool = False) -> str:
    """Serialize the serving function (reference ``saved_model.py:54-192``;
    chief-only, like rank0-only export there). ``id_mappers``
    ({column: IdMapper}) bundles dynamic-table id resolution for
    cold-process serving. ``poly_batch=True`` exports a symbolic batch
    dimension (one bundle serves any batch size)."""
    from hybridbackend_tpu.training.saved_model import export
    if self._ctx.is_chief:
      export(lambda p, b: self._loss_fn(p, b)[1]['preds'],
             self.params, example_batch, path, id_mappers=id_mappers,
             poly_batch=poly_batch)
    return path


class SparseTrainer(Trainer):
  """Trainer whose tables update via the row-sparse path.

  Same lifecycle (train/evaluate/checkpoints/hooks) but the jitted step
  is ``make_sparse_train_step``: no dense ``[V, D]`` table gradients.

  Args:
    fx: StackedFeatureExtractor declaring the tables.
    model_loss: ``(dense_params, emb_features, dense_features, batch)
      -> (loss, aux)``.
    dense_params: the tower params; tables come from ``fx.init``.
    raw_model_loss: ``(dense_params, member_embs, batch) -> (loss,
      aux)`` — receives UNCOMBINED per-member embeddings (sequence
      models, e.g. DIN attention over the raw [B, L, D] history). When
      set, ``model_loss`` is ignored (pass ``None``).
  """

  def __init__(self, fx, model_loss: Callable, dense_params: Any,
               tables: Optional[Dict[str, Any]] = None,
               dense_optimizer: Optional[optax.GradientTransformation] = None,
               table_lr: float = 0.05,
               adagrad_init: float = 0.1,
               table_optimizer: str = 'adagrad',
               raw_model_loss: Optional[Callable] = None,
               model_dir: Optional[str] = None,
               ctx: Optional[Context] = None,
               label_key: str = 'label',
               group_key: Optional[str] = None,
               rng: Optional[jax.Array] = None,
               caches: Optional[Dict[str, Any]] = None):
    """``caches`` maps batch column names to ``EmbeddingCache``
    instances backing that column's fx table (declare the table with
    ``cache.slot_config()``; the cache's host tables must be named
    'value' plus one 'slot{i}' per optimizer slot — 1 for adagrad, 2
    for adam). Ids are host-mapped to cache slots every step and cache
    maintenance (write-back, upload) is applied to the live state in
    step order (reference EmbeddingService hooks,
    ``service.py:253-324``)."""
    from hybridbackend_tpu.training.sparse_step import (
        SparseTrainState, make_sparse_train_step)
    self._ctx = ctx or Context.get()
    self._fx = fx
    self._label_key = label_key
    self._group_key = group_key
    self._model_loss = model_loss
    self._raw_model_loss = raw_model_loss
    self._caches = dict(caches) if caches else {}
    if caches:
      from hybridbackend_tpu.embedding.service import CacheRunner
      nslots = 2 if table_optimizer == 'adam' else 1
      want = {'value'} | {f'slot{i}' for i in range(nslots)}
      for col, cache in caches.items():
        have = set(cache.device.keys())
        if have != want:
          raise ValueError(
              f'cache for column {col!r} has tables {sorted(have)}; '
              f'{table_optimizer} needs exactly {sorted(want)}')
      self._cache_runner = CacheRunner(caches, fx)
      self._host_transform = self._cache_runner.transform
      self._eval_host_transform = self._cache_runner.eval_transform
    if dense_optimizer is None:
      dense_optimizer = optax.adam(1e-3)
    if tables is None:
      if table_optimizer == 'adam':
        # LazyAdam tables never lane-pack (per-row moment presence
        # would decay neighboring logical rows' moments) — the
        # emb_lane_pack option cannot see the optimizer, so disable it
        # here before the tables are materialized.
        from hybridbackend_tpu.framework.options import OPTIONS as _OPTS
        with _OPTS.override(emb_lane_pack='off'):
          tables = fx.init(rng if rng is not None else jax.random.PRNGKey(0))
      else:
        tables = fx.init(rng if rng is not None else jax.random.PRNGKey(0))
    self.state = SparseTrainState.create(
        dense_params, tables, dense_optimizer, adagrad_init, self._ctx,
        adam=(table_optimizer == 'adam'))
    self._step_fn = make_sparse_train_step(
        fx, model_loss, dense_optimizer, table_lr, self._ctx,
        table_optimizer=table_optimizer, raw_model_loss=raw_model_loss)

    if raw_model_loss is not None:
      from hybridbackend_tpu.embedding.stack import unpack_embeddings
      stacks_by_name = {s.stacked.name: s for s in fx.stacks}

      def eval_fn(params, batch):
        dense, tables = params
        raw, _, layouts = fx.lookup_raw(tables, batch)
        members = {}
        for name, emb in raw.items():
          members.update(unpack_embeddings(
              stacks_by_name[name], emb, layouts[name]))
        return raw_model_loss(dense, members, batch)
    else:
      def eval_fn(params, batch):
        dense, tables = params
        emb_f, dense_f = fx(tables, batch)
        return model_loss(dense, emb_f, dense_f, batch)

    self._eval_fn = make_eval_step(eval_fn, self._ctx)
    self._loss_fn = eval_fn
    model_dir = model_dir or OPTIONS['model_dir']
    self._ckpt = None
    if model_dir and model_dir != '.':
      self._model_dir = model_dir
      self._ckpt = CheckpointManager(model_dir)
      restored = self._ckpt.restore(self.state)
      if restored is not self.state:
        LOG.info('restored checkpoint at step %s',
                 int(np.asarray(restored.step)))
      self.state = restored

  @property
  def params(self):
    return (self.state.dense, self.state.tables)

  def export_saved_model(self, path: str, example_batch,
                         id_mappers=None,
                         table_dtype: str = 'float32',
                         poly_batch: bool = False) -> str:
    """Export a STANDALONE serving bundle (reference ``export_all``
    semantics, ``saved_model.py:54-192``): the serving graph is rebuilt
    per-member from the trained state — stacked physical tables are
    split back into member tables, and cache-backed columns serve from
    their FULL host tables (cache flushed to storage first), so a cold
    process reproduces training-time predictions without the cache or
    the trainer. Ragged (padded ids + ``col_mask``) inputs export
    per the signature's padded+mask contract; pass ``id_mappers``
    ({column: IdMapper}) to bundle dynamic-table id resolution.

    ``table_dtype='int8'`` exports per-row symmetric int8 tables
    (``embedding/quant.py``): ~4× smaller serving bundles / 4× more
    vocab per chip, dequantized after the gather (a capacity win;
    its effect on predict latency on the GPU is not measured); the
    dense tower stays float.

    ``example_batch`` must carry every column the loss function reads
    (including a dummy label column). EVERY process must call this
    (materializing row-sharded stacks is a collective gather); only the
    chief writes the bundle, like rank0-only export in the reference."""
    import dataclasses as _dc
    from hybridbackend_tpu.embedding.stack import member_tables
    from hybridbackend_tpu.models.feature import EmbeddingSpec
    from hybridbackend_tpu.training.saved_model import export

    # Collective phase — all processes participate: sharded stacks span
    # non-addressable devices, so member_tables all-gathers them.
    extracted: Dict[str, Dict[str, Any]] = {}
    for spec in self._fx.specs:
      if spec.key in self._caches:
        continue
      stack = self._fx._stack_of[spec.config.name]
      sname = stack.stacked.name
      if sname not in extracted:
        extracted[sname] = member_tables(
            stack, self.state.tables[sname], self._ctx)

    if not self._ctx.is_chief:
      return path

    if self._cache_runner is not None:
      # Make storage authoritative without consuming pending plans.
      self._cache_runner.checkpoint_flush(self.state)
    serving_tables: Dict[str, Any] = {}
    serving_specs = []
    for spec in self._fx.specs:
      name = spec.config.name
      if spec.key in self._caches:
        cache = self._caches[spec.key]
        vocab = cache.config.vocab_size
        full = np.asarray(
            cache.storage.pull('value', np.arange(vocab, dtype=np.int64)))
        cfg = _dc.replace(cache.config, sharded=False, shuffle_ids=False,
                           lane_pack=False)
        serving_tables[name] = full
        serving_specs.append(EmbeddingSpec(cfg, column=spec.key))
        continue
      stack = self._fx._stack_of[name]
      sname = stack.stacked.name
      serving_tables[name] = extracted[sname][name]
      # Stacked lookups address members at offset+raw_id (member
      # shuffle_ids is not applied inside a stack), so the extracted
      # contiguous slice serves with identity row mapping.
      cfg = _dc.replace(spec.config, sharded=False, shuffle_ids=False,
                        lane_pack=False)
      serving_specs.append(EmbeddingSpec(cfg, column=spec.column))

    raw_loss = self._raw_model_loss
    model_loss = self._model_loss
    dense_cols = list(self._fx.dense_columns)

    def serving_fn(params, batch):
      dense, tables = params
      if raw_loss is not None:
        from hybridbackend_tpu.embedding.lookup import lookup
        members = {
            s.config.name: lookup(tables[s.config.name],
                                  jnp.asarray(batch[s.key]), s.config)
            for s in serving_specs}
        _, aux = raw_loss(dense, members, batch)
      else:
        from hybridbackend_tpu.models.feature import extract_features
        emb_f, dense_f = extract_features(tables, batch, serving_specs,
                                          dense_cols)
        _, aux = model_loss(dense, emb_f, dense_f, batch)
      return aux['preds']

    if table_dtype == 'int8':
      from hybridbackend_tpu.embedding.quant import quantize_table
      serving_tables = {n: quantize_table(t)
                        for n, t in serving_tables.items()}
    elif table_dtype != 'float32':
      raise ValueError(f'table_dtype must be float32 or int8, '
                       f'got {table_dtype!r}')

    host_dense = jax.tree_util.tree_map(np.asarray, self.state.dense)
    return export(serving_fn, (host_dense, serving_tables),
                  example_batch, path, id_mappers=id_mappers,
                  poly_batch=poly_batch)


__all__ = ['Trainer', 'SparseTrainer']
