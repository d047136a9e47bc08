"""Hybrid train step with row-sparse table updates.

The reference's split-gradient training (``gradient.py:119-218``):
replicated dense gradients are allreduced and applied by the wrapped
optimizer; sharded embedding gradients stay ``IndexedSlices`` and touch
only their rows. This module is the jitted-step embodiment:

* dense params → any optax optimizer (GSPMD allreduce);
* tables → :mod:`hybridbackend_tpu.embedding.sparse_update` Adagrad on
  touched rows only, so the update's cost follows the batch, not the
  table size.

The step differentiates w.r.t. the *looked-up embeddings* (not the
tables), so no dense ``[V, D]`` gradient ever materializes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from hybridbackend_tpu.embedding.sparse_update import (
    SparseOptState, init_adagrad_state, init_adam_state,
    sparse_adagrad_apply, sparse_adam_apply)
from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.models.feature import StackedFeatureExtractor
from hybridbackend_tpu.training.train import replicate_over_mesh


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SparseTrainState:
  step: jax.Array
  dense: Any                           # dense (tower) params
  tables: Dict[str, jax.Array]         # one physical table per stack
  table_opt: Dict[str, SparseOptState]
  dense_opt: Any

  @classmethod
  def create(cls, dense_params, tables: Dict[str, jax.Array],
             dense_optimizer: optax.GradientTransformation,
             adagrad_init: float = 0.1,
             ctx: Optional[Context] = None, *,
             adam: bool = False) -> 'SparseTrainState':
    ctx = ctx or Context.get()
    dense_params = replicate_over_mesh(dense_params, ctx)
    if adam:
      table_opt = {name: init_adam_state(t) for name, t in tables.items()}
    else:
      table_opt = {name: init_adagrad_state(t, adagrad_init)
                   for name, t in tables.items()}
    step = jax.device_put(jnp.zeros((), jnp.int32),
                          ctx.replicated_sharding)
    return cls(step=step, dense=dense_params, tables=tables,
               table_opt=table_opt,
               dense_opt=replicate_over_mesh(
                   dense_optimizer.init(dense_params), ctx))


def make_sparse_train_step(
    fx: StackedFeatureExtractor,
    model_loss: Callable[[Any, list, list, Dict], Tuple[jax.Array, Dict]],
    dense_optimizer: optax.GradientTransformation,
    table_lr: float = 0.05,
    ctx: Optional[Context] = None, *,
    table_dedup: bool = True,
    table_optimizer: str = 'adagrad',
    raw_model_loss: Optional[Callable] = None,
    donate_state: bool = True) -> Callable:
  """Build the jitted sparse-update train step.

  Args:
    fx: the feature extractor declaring all embedding tables (stacked).
    model_loss: ``(dense_params, emb_features, dense_features, batch) ->
      (scalar_loss, aux)`` — the model from combined features onward.
    dense_optimizer: optax transform for the dense tower.
    table_lr: learning rate for all tables.
    table_dedup: exact duplicate-id combining before squaring; False
      uses TF ``SparseApplyAdagrad`` semantics and skips the sort
      (adagrad only).
    table_optimizer: 'adagrad' (accumulator slot) or 'adam' (LazyAdam,
      m/v slots — create the state with ``adam=True``).
    raw_model_loss: ``(dense_params, member_embs {name: [B, ..., D]},
      batch) -> (scalar_loss, aux)`` — alternative model hook receiving
      UNCOMBINED per-member embeddings (each member id column's original
      shape + (dim,)). For sequence models (DIN attention pooling over a
      [B, L, D] history) that consume embeddings before any combiner.
      When set, ``model_loss`` is ignored (pass ``None``).

  Returns ``step(state, batch) -> (state, metrics)``.
  """
  from hybridbackend_tpu.embedding.stack import unpack_embeddings
  ctx = ctx or Context.get()
  if table_optimizer not in ('adagrad', 'adam'):
    raise ValueError(f'Unknown table_optimizer {table_optimizer!r}; '
                     "expected 'adagrad' or 'adam'")
  stacks_by_name = {s.stacked.name: s for s in fx.stacks}

  from hybridbackend_tpu.training.train import (
      _batch_spec, _grad_wire_dtype)
  wire = _grad_wire_dtype()
  use_wire = wire is not None and ctx.world_size > 1

  def step(state: SparseTrainState, batch):
    # 1. Fused lookups; tables are NOT differentiated.
    with jax.named_scope('lookup'):
      raw, ids_by_stack, layouts = fx.lookup_raw(state.tables, batch)
      raw = jax.tree_util.tree_map(jax.lax.stop_gradient, raw)

    # 2. Differentiate w.r.t. dense params AND the raw embeddings.
    # ``layouts`` is static metadata (safe to close over); ``batch`` is
    # threaded explicitly so the wire-compressed path can shard it.
    # The 'tower' scope names the forward and, through autodiff, the
    # backward pass.
    @jax.named_scope('tower')
    def loss_from(dense, raw_embs, batch_):
      if raw_model_loss is not None:
        members = {}
        for name, emb in raw_embs.items():
          members.update(unpack_embeddings(
              stacks_by_name[name], emb, layouts[name]))
        return raw_model_loss(dense, members, batch_)
      emb_f, dense_f = fx.combine_from_raw(raw_embs, layouts, batch_)
      return model_loss(dense, emb_f, dense_f, batch_)

    if use_wire:
      # Dense-tower gradient reduction at comm_gradient_wire_dtype
      # (reference: gradient collectives cast on the wire,
      # collective.py:291-296). The dense params are replicated and the
      # raw embeddings / batch are batch-leading, so the manual-SPMD
      # body sees exactly the per-device slice semantics GSPMD gives
      # the global-array trace; raw-embedding grads stay batch-local.
      from jax.sharding import PartitionSpec as P
      axes = ctx.data_axes
      world = ctx.world_size

      def body(dense_l, raw_l, batch_l):
        (loss, aux), (dg, dr) = jax.value_and_grad(
            lambda d, r: loss_from(d, r, batch_l),
            argnums=(0, 1), has_aux=True)(dense_l, raw_l)
        dg = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g.astype(wire), axes)
            .astype(g.dtype) / world, dg)
        # The in-body loss is a mean over the LOCAL batch slice; the
        # GSPMD path's per-row embedding grads carry the GLOBAL 1/B
        # weight, so rescale (same mean-loss convention as the dense
        # wire path in training/train.py).
        dr = jax.tree_util.tree_map(lambda g: g / world, dr)
        loss = jax.lax.pmean(loss, axes)
        aux = jax.tree_util.tree_map(
            lambda a: jax.lax.pmean(a, axes) if jnp.ndim(a) == 0 else a,
            aux)
        return loss, aux, dg, dr

      bspec = lambda t: jax.tree_util.tree_map(
          lambda l: _batch_spec(l, axes), t)
      dspecs = jax.tree_util.tree_map(lambda l: P(), state.dense)
      aux_shapes = jax.eval_shape(
          lambda d, r, b: loss_from(d, r, b)[1], state.dense, raw, batch)
      aux_specs = jax.tree_util.tree_map(
          lambda a: P() if jnp.ndim(a) == 0 else _batch_spec(a, axes),
          aux_shapes)
      fn = jax.shard_map(
          body, mesh=ctx.mesh,
          in_specs=(dspecs, bspec(raw), bspec(batch)),
          out_specs=(P(), aux_specs, dspecs, bspec(raw)),
          check_vma=False)
      loss, aux, dgrads, draw = fn(state.dense, raw, batch)
    else:
      (loss, aux), (dgrads, draw) = jax.value_and_grad(
          loss_from, argnums=(0, 1), has_aux=True)(state.dense, raw,
                                                   batch)

    # 3. Dense update (optax; GSPMD handles the allreduce).
    with jax.named_scope('dense_update'):
      updates, dense_opt = dense_optimizer.update(
          dgrads, state.dense_opt, state.dense)
      dense = optax.apply_updates(state.dense, updates)

    # 4. Row-sparse optimizer per stacked table.
    tables = dict(state.tables)
    table_opt = dict(state.table_opt)
    for name, demb in draw.items():
      stack = stacks_by_name[name]
      with jax.named_scope('table_update'):
        if table_optimizer == 'adam':
          tables[name], table_opt[name] = sparse_adam_apply(
              tables[name], table_opt[name], ids_by_stack[name], demb,
              stack.stacked, table_lr, step=state.step + 1, ctx=ctx)
        else:
          tables[name], table_opt[name] = sparse_adagrad_apply(
              tables[name], table_opt[name], ids_by_stack[name], demb,
              stack.stacked, table_lr, dedup=table_dedup, ctx=ctx)

    new_state = SparseTrainState(
        step=state.step + 1, dense=dense, tables=tables,
        table_opt=table_opt, dense_opt=dense_opt)
    metrics = dict(aux)
    metrics['loss'] = loss
    return new_state, metrics

  return jax.jit(step, donate_argnums=(0,) if donate_state else ())


__all__ = ['SparseTrainState', 'make_sparse_train_step']
