"""Optimizer integration: replicated vs sharded parameter handling.

A JAX re-design of the reference's optimizer wrapping + gradient
aggregation (``/root/reference/hybridbackend/tensorflow/training/optimizer.py:55-185``
and ``gradient.py:119-218``). The reference mixes an aggregation base
class into every TF optimizer: replicated dense grads are allreduced and
averaged, replicated sparse grads allgathered, and sharded (embedding)
grads applied locally without any communication.

Under JAX+GSPMD the *mechanism* disappears: a jitted train step whose
batch is sharded and whose dense params are replicated gets the gradient
all-reduce inserted by the partitioner, and gradients of row-sharded
tables come out row-sharded (local). What remains framework-worthy:

* :func:`sharding_aware` — constrain optimizer state to live with its
  parameter (so Adagrad accumulators of a sharded table are sharded);
* :func:`split_trees` / predicates for table vs dense params, used by
  multi-optimizer setups (e.g. Adagrad on tables + Adam on dense, the
  canonical wide-and-deep recipe);
* scale-invariant grad averaging matching the reference's ``1/world``
  mean (``gradient.py:157-218``) — implicit in ``pmean``-style loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from hybridbackend_tpu.framework.context import Context


def is_embedding_path(path: Tuple, _leaf=None) -> bool:
  """Default predicate: parameters under a subtree named 'tables' or with
  a key containing 'embedding' are sharded embedding params."""
  for p in path:
    key = getattr(p, 'key', getattr(p, 'name', None))
    if key is not None and ('table' in str(key) or 'embedding' in str(key)):
      return True
  return False


def split_trees(tree, predicate=is_embedding_path):
  """Split a pytree into (matching, rest) masks for optax.masked."""
  flat = jax.tree_util.tree_flatten_with_path(tree)[0]
  match_mask = jax.tree_util.tree_unflatten(
      jax.tree_util.tree_structure(tree),
      [predicate(path, leaf) for path, leaf in flat])
  inverse = jax.tree_util.tree_map(lambda b: not b, match_mask)
  return match_mask, inverse


def multi_optimizer(table_opt: optax.GradientTransformation,
                    dense_opt: optax.GradientTransformation,
                    predicate=is_embedding_path) -> Callable:
  """Build a combined optimizer applying ``table_opt`` to embedding
  params and ``dense_opt`` to the rest (reference: per-collection
  optimizers; canonical recipe = Adagrad tables + Adam dense).

  Returns a function ``params -> optax.GradientTransformation`` (masks
  depend on the tree structure)."""

  def build(params) -> optax.GradientTransformation:
    table_mask, dense_mask = split_trees(params, predicate)
    return optax.chain(
        optax.masked(table_opt, table_mask),
        optax.masked(dense_opt, dense_mask),
    )

  return build


def sharding_aware_init(optimizer: optax.GradientTransformation,
                        params,
                        ctx: Optional[Context] = None):
  """Initialize optimizer state with state arrays co-sharded with their
  parameters (a row-sharded table's Adagrad accumulator must be
  row-sharded too, or it replicates the whole table on every chip —
  reference equivalent: per-shard slot variables, ``optimizer.py:120-185``).
  """
  ctx = ctx or Context.get()

  def mesh_sharding(p):
    # Only propagate shardings that span the context mesh; params living
    # on a single (default) device are replicated over the mesh instead.
    if isinstance(p, jax.Array) and hasattr(p.sharding, 'spec') and \
        len(p.sharding.device_set) > 1:
      return p.sharding
    return None

  param_shardings = jax.tree_util.tree_map(mesh_sharding, params)

  def init(params):
    return optimizer.init(params)

  state = jax.eval_shape(init, params)

  def state_sharding(leaf_shape):
    # Match state leaves to param shardings by shape: a state leaf with
    # the same shape as some param inherits that param's sharding.
    shape = leaf_shape.shape
    found = [None]

    def visit(p, s):
      if s is not None and isinstance(p, jax.Array) and p.shape == shape:
        found[0] = s
    jax.tree_util.tree_map(visit, params, param_shardings)
    if found[0] is not None:
      return found[0]
    return ctx.replicated_sharding

  shardings = jax.tree_util.tree_map(state_sharding, state)
  return jax.jit(init, out_shardings=shardings)(params)


__all__ = ['is_embedding_path', 'split_trees', 'multi_optimizer',
           'lr_with_linear_warmup_and_polynomial_decay',
           'sharding_aware_init']


def lr_with_linear_warmup_and_polynomial_decay(
    initial_value: float = 24.0,
    scaling_factor: float = 1.0,
    warmup_steps=None,
    decay_steps=None,
    decay_start_step=None,
    decay_exp: int = 2,
    epsilon: float = 1e-7):
  """Optax-style schedule: linear warmup then polynomial decay.

  Port of the reference tutorial's DLRM learning-rate schedule
  (``/root/reference/docs/tutorial/ranking/optimization.py:26-80``).
  Returns ``schedule(step) -> lr`` usable as any optax learning rate.
  """
  import jax.numpy as jnp
  initial_lr = initial_value * scaling_factor

  def schedule(step):
    step = jnp.asarray(step, jnp.float32)
    if warmup_steps is None:
      return jnp.asarray(initial_lr, jnp.float32)
    warmup_rate = initial_lr / warmup_steps
    warmup_lr = initial_lr - (warmup_steps - step) * warmup_rate
    if decay_steps is None or decay_start_step is None:
      return warmup_lr
    decayed = jnp.minimum(step - decay_start_step, decay_steps)
    decay_lr = jnp.maximum(
        initial_lr * ((decay_steps - decayed) / decay_steps) ** decay_exp,
        epsilon)
    return jnp.where(step < warmup_steps, warmup_lr,
                     jnp.where(step > decay_start_step, decay_lr,
                               initial_lr))

  return schedule
