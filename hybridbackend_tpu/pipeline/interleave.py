"""Interleaved sparse/dense execution (PICASSO packing+interleaving).

The PICASSO paper's second pillar (reference README.md:66-79; the
reference realizes it with graph passes + separate CUDA streams):
overlap the embedding EXCHANGE of one micro-batch with the dense
COMPUTE of the previous one. In XLA the same overlap can fall out of
dataflow: inside one jitted ``lax.scan`` step, micro-batch ``i+1``'s
lookup (all_gather/all_to_all + gather — interconnect + HBM work) has
no data dependency on micro-batch ``i``'s tower (matmul work), so XLA's
latency-hiding scheduler can run them concurrently.

Semantics are EXACT accumulate-then-apply: every micro-batch looks up
the same table version; dense gradients average across micro-batches;
per-id embedding gradients concatenate into ONE row-sparse table update
at the end (one kernel pass for the whole step).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.models.feature import StackedFeatureExtractor
from hybridbackend_tpu.training.sparse_step import SparseTrainState

_TABLE_OPTIMIZERS = ('adagrad', 'adam')


def make_interleaved_train_step(
    fx: StackedFeatureExtractor,
    model_loss: Callable[[Any, list, list, Dict], Tuple[jax.Array, Dict]],
    dense_optimizer: optax.GradientTransformation,
    num_microbatches: int,
    table_lr: float = 0.05,
    ctx: Optional[Context] = None, *,
    table_optimizer: str = 'adagrad',
    donate_state: bool = True) -> Callable:
  """Pipelined variant of ``make_sparse_train_step``.

  The global batch splits into ``num_microbatches`` slices; slice
  ``i+1``'s fused lookup is issued in the same scan iteration as slice
  ``i``'s forward/backward, letting XLA overlap the exchange with the
  tower. Every batch column's leading dim must divide by
  ``num_microbatches`` (checked). Metrics: ``loss`` plus the
  ``model_loss`` aux values, concatenated over micro-batches along the
  batch axis where possible.
  """
  ctx = ctx or Context.get()
  if table_optimizer not in _TABLE_OPTIMIZERS:
    raise ValueError(f'Unknown table_optimizer {table_optimizer!r}; '
                     f'expected one of {_TABLE_OPTIMIZERS}')
  stacks_by_name = {s.stacked.name: s for s in fx.stacks}
  from hybridbackend_tpu.embedding.sparse_update import (
      sparse_adagrad_apply, sparse_adam_apply)
  from hybridbackend_tpu.embedding.stack import pack_ids

  def step(state: SparseTrainState, batch):
    k = num_microbatches
    for key, col in batch.items():
      if hasattr(col, 'shape') and col.shape and col.shape[0] % k:
        raise ValueError(
            f'Batch column {key!r} has leading dim {col.shape[0]}, '
            f'not divisible by num_microbatches={k}')

    def mb(tree, i):
      def slice_one(x):
        m = x.shape[0] // k
        return jax.lax.dynamic_slice_in_dim(x, i * m, m, axis=0)
      return jax.tree_util.tree_map(slice_one, tree)

    def lookup_mb(i):
      raw, _, layouts = fx.lookup_raw(state.tables, mb(batch, i))
      raw = jax.tree_util.tree_map(jax.lax.stop_gradient, raw)
      return raw, layouts

    def tower_grad(raw, layouts, batch_i):
      def loss_from(dense, raw_embs):
        emb_f, dense_f = fx.combine_from_raw(raw_embs, layouts, batch_i)
        return model_loss(dense, emb_f, dense_f, batch_i)
      return jax.value_and_grad(loss_from, argnums=(0, 1),
                                has_aux=True)(state.dense, raw)

    # Software pipeline: carry micro-batch i's embeddings; issue i+1's
    # lookup in the same iteration as i's tower (independent subgraphs
    # → XLA overlaps the exchange with the matmuls). The scan runs
    # k-1 iterations; the last micro-batch's tower follows outside, so
    # exactly k lookups are issued per step.
    raw0, layouts = lookup_mb(0)
    zero_dense = jax.tree_util.tree_map(jnp.zeros_like, state.dense)

    def body(carry, i):
      raw_i, loss_acc, dgrad_acc = carry
      raw_next, _ = lookup_mb(i + 1)           # overlaps tower below
      (loss, aux), (dgrads, draw) = tower_grad(raw_i, layouts,
                                               mb(batch, i))
      dgrad_acc = jax.tree_util.tree_map(jnp.add, dgrad_acc, dgrads)
      return (raw_next, loss_acc + loss, dgrad_acc), (draw, aux)

    if k > 1:
      (raw_last, loss_sum, dgrads), (draws, auxs) = jax.lax.scan(
          body, (raw0, jnp.zeros(()), zero_dense), jnp.arange(k - 1))
    else:
      raw_last, loss_sum, dgrads = raw0, jnp.zeros(()), zero_dense
      draws, auxs = None, None
    (loss_k, aux_k), (dgrads_k, draw_k) = tower_grad(
        raw_last, layouts, mb(batch, k - 1))
    dgrads = jax.tree_util.tree_map(jnp.add, dgrads, dgrads_k)
    scale = 1.0 / k
    dgrads = jax.tree_util.tree_map(lambda g: g * scale, dgrads)
    loss = (loss_sum + loss_k) * scale

    def stitch(scanned, last):
      # [k-1, mb, ...] + [mb, ...] -> [k*mb, ...]; scalars average.
      if last.ndim == 0:
        if scanned is None:
          return last
        return (jnp.sum(scanned) + last) * scale
      if scanned is None:
        return last
      flat = scanned.reshape(-1, *scanned.shape[2:])
      return jnp.concatenate([flat, last], axis=0)

    if auxs is None:
      aux = aux_k
    else:
      aux = jax.tree_util.tree_map(lambda s, l: stitch(s, l), auxs, aux_k)

    # Dense update.
    updates, dense_opt = dense_optimizer.update(dgrads, state.dense_opt,
                                                state.dense)
    dense = optax.apply_updates(state.dense, updates)

    # One sparse table update per stack for the WHOLE step. The per-mb
    # embedding grads concatenate along the batch axis; since mb() takes
    # contiguous slices, the matching ids are simply the FULL batch's
    # packed ids. Gradients are averaged (the dense path divides by k;
    # per-id grads must too).
    member_full = fx.member_ids(batch)
    tables = dict(state.tables)
    table_opt = dict(state.table_opt)
    for name in (draw_k or {}):
      stack = stacks_by_name[name]
      ids, _ = pack_ids(stack, member_full[name])            # [B, K]
      if draws is None:
        demb = draw_k[name] * scale
      else:
        flat = draws[name].reshape(-1, *draws[name].shape[2:])
        demb = jnp.concatenate([flat, draw_k[name]], axis=0) * scale
      if table_optimizer == 'adam':
        tables[name], table_opt[name] = sparse_adam_apply(
            tables[name], table_opt[name], ids, demb, stack.stacked,
            table_lr, step=state.step + 1, ctx=ctx)
      else:
        tables[name], table_opt[name] = sparse_adagrad_apply(
            tables[name], table_opt[name], ids, demb, stack.stacked,
            table_lr, ctx=ctx)

    new_state = SparseTrainState(
        step=state.step + 1, dense=dense, tables=tables,
        table_opt=table_opt, dense_opt=dense_opt)
    metrics = dict(aux)
    metrics['loss'] = loss
    return new_state, metrics

  return jax.jit(step, donate_argnums=(0,) if donate_state else ())


__all__ = ['make_interleaved_train_step']
