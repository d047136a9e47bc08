"""Micro-batch pipelining (gradient accumulation).

A JAX re-design of the reference's ``compute_pipeline`` +
``PipelinedOptimizer`` (``/root/reference/hybridbackend/tensorflow/pipeline/pipeline_lib.py:73-244``):
``data_batch_count > 1`` splits each training step into several
micro-batches whose dense gradients are accumulated (``accumulate_n``)
before a single optimizer apply. In JAX this is a ``lax.scan`` over
micro-batches inside the jitted step — XLA keeps the accumulation in
registers/HBM without host round-trips, and remat keeps memory flat.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('data_batch_count', 1, env='HB_DATA_BATCH_COUNT',
                 doc='Micro-batches per optimizer step (1 = disabled).')


def accumulate_gradients(loss_fn: Callable, num_microbatches: int,
                         remat: bool = True) -> Callable:
  """Wrap ``loss_fn(params, batch) -> (loss, aux)`` so gradients are
  averaged over ``num_microbatches`` slices of the leading batch dim.

  Returns a drop-in ``grad_fn(params, batch) -> ((loss, aux), grads)``
  replacement for ``jax.value_and_grad(loss_fn, has_aux=True)``; feed it
  to a custom train step, or use :func:`make_pipelined_train_step`.
  """
  vg = jax.value_and_grad(loss_fn, has_aux=True)
  if remat:
    vg = jax.checkpoint(vg)

  def grad_fn(params, batch):
    def slice_mb(x, i):
      mb = x.shape[0] // num_microbatches
      return jax.lax.dynamic_slice_in_dim(x, i * mb, mb, axis=0)

    def body(carry, i):
      acc_loss, acc_grads = carry
      mb = jax.tree_util.tree_map(lambda x: slice_mb(x, i), batch)
      (loss, aux), grads = vg(params, mb)
      acc_grads = jax.tree_util.tree_map(jnp.add, acc_grads, grads)
      return (acc_loss + loss, acc_grads), aux

    zero_grads = jax.tree_util.tree_map(jnp.zeros_like, params)
    (total_loss, grads), auxs = jax.lax.scan(
        body, (jnp.zeros(()), zero_grads),
        jnp.arange(num_microbatches))
    scale = 1.0 / num_microbatches
    grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
    aux = jax.tree_util.tree_map(lambda a: a.reshape(-1, *a.shape[2:])
                                 if a.ndim >= 2 else a, auxs)
    return (total_loss * scale, aux), grads

  return grad_fn


def make_pipelined_train_step(loss_fn: Callable, optimizer,
                              num_microbatches: int,
                              ctx=None, donate_state: bool = True):
  """A ``make_train_step`` variant with micro-batch accumulation
  (reference ``PipelinedOptimizer.minimize``)."""
  import optax
  from hybridbackend_tpu.training.train import TrainState

  grad_fn = accumulate_gradients(loss_fn, num_microbatches)

  def step(state: TrainState, batch):
    (loss, aux), grads = grad_fn(state.params, batch)
    updates, opt_state = optimizer.update(grads, state.opt_state,
                                          state.params)
    params = optax.apply_updates(state.params, updates)
    new_state = TrainState(step=state.step + 1, params=params,
                           opt_state=opt_state)
    metrics = {'loss': loss}
    return new_state, metrics

  return jax.jit(step, donate_argnums=(0,) if donate_state else ())


__all__ = ['accumulate_gradients', 'make_pipelined_train_step']

from hybridbackend_tpu.pipeline.interleave import make_interleaved_train_step  # noqa: E402,F401
__all__.append('make_interleaved_train_step')
