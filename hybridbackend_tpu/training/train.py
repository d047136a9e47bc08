"""Train/eval step construction over the context mesh.

A JAX replacement for the reference's ``MonitoredTrainingSession``
graph machinery (``/root/reference/hybridbackend/tensorflow/training/session.py:43-164``):
in JAX a training step is a pure jitted function of ``(state, batch)``.
The reference's per-step concerns map as:

* hybrid parallelism — batch sharded over the mesh, dense params
  replicated (GSPMD inserts grad allreduce = reference
  ``aggregate_gradients``), tables row-sharded (grads stay local);
* variable init broadcast (reference ``optimizer.py:220-290``) —
  parameters are initialized once with a seeded PRNG and placed with
  explicit shardings, so every replica is identical by construction;
* loss scaling by world size — ``loss = mean over global batch``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from jax.sharding import PartitionSpec as P

from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.framework.options import OPTIONS
from hybridbackend_tpu.training.optimizer import sharding_aware_init


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
  """Carried training state (params + optimizer state + step)."""
  step: jax.Array
  params: Any
  opt_state: Any

  @classmethod
  def create(cls, params, optimizer: optax.GradientTransformation,
             ctx: Optional[Context] = None) -> 'TrainState':
    ctx = ctx or Context.get()
    params = replicate_over_mesh(params, ctx)
    opt_state = sharding_aware_init(optimizer, params, ctx)
    step = jax.device_put(jnp.zeros((), jnp.int32),
                          ctx.replicated_sharding)
    return cls(step=step, params=params, opt_state=opt_state)


def replicate_over_mesh(tree, ctx: Optional[Context] = None):
  """Commit every array without a mesh sharding to a replicated placement
  on the context mesh. Sharded arrays (embedding tables) pass through.

  This is the reference's "replica variables initialized identically"
  guarantee (``optimizer.py:220-290``) — and it keeps checkpoint
  restores mesh-committed instead of single-device."""
  ctx = ctx or Context.get()

  def place(p):
    if isinstance(p, jax.Array) and len(p.sharding.device_set) > 1:
      return p
    if isinstance(p, (jax.Array, jnp.ndarray)) or hasattr(p, 'shape'):
      return jax.device_put(p, ctx.replicated_sharding)
    return p

  return jax.tree_util.tree_map(place, tree)


def _grad_wire_dtype():
  w = OPTIONS['comm_gradient_wire_dtype']
  return None if w in ('float32', '', None) else jnp.dtype(w)


def _leaf_spec(leaf, axes):
  """PartitionSpec of a params leaf: its committed sharding spec when
  mesh-sharded, replicated otherwise."""
  sh = getattr(leaf, 'sharding', None)
  if sh is not None and getattr(sh, 'spec', None) is not None:
    if any(s is not None for s in tuple(sh.spec)):
      return sh.spec
  return P()


def _batch_spec(leaf, axes):
  nd = getattr(leaf, 'ndim', 0)
  return P(axes, *([None] * (nd - 1))) if nd >= 1 else P()


def make_wire_grad_fn(loss_fn: Callable, params_template, ctx: Context,
                      wire) -> Callable:
  """Gradient function whose cross-replica grad reduction rides the wire
  in ``comm_gradient_wire_dtype`` (reference: gradient collectives are
  cast on the wire generally, ``distribute/collective.py:291-296`` +
  ``common/cast.cu.cc:37-488``).

  GSPMD's implicit allreduce of replicated-param gradients always runs
  at accumulator precision; this builds the data-parallel reduction
  explicitly under ``shard_map`` so the summand can be cast: per-device
  grads → cast(wire) → psum → cast back → /W. Row-sharded leaves (e.g.
  embedding tables) keep their local gradients — never allreduced,
  matching ``gradient.py:197-207``.

  Contract (same as the Trainer's): the loss is a mean over the batch
  rows it is given; scalar aux entries are pmean'd, array aux entries
  have a leading batch axis.
  """
  axes = ctx.data_axes
  world = ctx.world_size
  pspecs = jax.tree_util.tree_map(lambda l: _leaf_spec(l, axes),
                                  params_template)
  if any(any(s is not None for s in tuple(spec))
         for spec in jax.tree_util.tree_leaves(
             pspecs, is_leaf=lambda x: isinstance(x, P))):
    # A mesh-sharded leaf (e.g. a row-sharded table with dense grads)
    # cannot run under the manual-SPMD body: the user's loss_fn indexes
    # it as a GLOBAL array. Let GSPMD keep the whole step (its grad
    # allreduce rides at f32). The hybrid path with compressed exchanges
    # is SparseTrainer/make_sparse_train_step.
    import logging
    logging.getLogger('hybridbackend_tpu').warning(
        'comm_gradient_wire_dtype: params contain mesh-sharded leaves; '
        'dense-grad wire compression disabled for this step (use the '
        'sparse-update path for sharded tables).')
    return None

  def grad_fn(params, batch):
    bspecs = jax.tree_util.tree_map(lambda l: _batch_spec(l, axes), batch)

    def body(params_l, batch_l):
      (loss, aux), g = jax.value_and_grad(
          loss_fn, has_aux=True)(params_l, batch_l)
      g = jax.tree_util.tree_map(
          lambda grad: jax.lax.psum(grad.astype(wire), axes)
          .astype(grad.dtype) / world, g)
      loss = jax.lax.pmean(loss, axes)
      aux_out = jax.tree_util.tree_map(
          lambda a: jax.lax.pmean(a, axes) if jnp.ndim(a) == 0 else a, aux)
      return loss, aux_out, g

    # Out-specs: loss replicated; aux per-leaf (scalar→replicated,
    # array→batch-sharded); grads replicated (psum'd in-body).
    def aux_spec(a):
      return P() if jnp.ndim(a) == 0 else _batch_spec(a, axes)

    shapes = jax.eval_shape(lambda p, b: loss_fn(p, b)[1], params, batch)
    aux_specs = jax.tree_util.tree_map(aux_spec, shapes)
    fn = jax.shard_map(
        body, mesh=ctx.mesh,
        in_specs=(pspecs, bspecs),
        out_specs=(P(), aux_specs, pspecs),
        check_vma=False)
    return fn(params, batch)

  return grad_fn


def make_train_step(loss_fn: Callable[[Any, Dict[str, jax.Array]],
                                      Tuple[jax.Array, Dict[str, jax.Array]]],
                    optimizer: optax.GradientTransformation,
                    ctx: Optional[Context] = None,
                    donate_state: bool = True,
                    params_template: Any = None) -> Callable:
  """Build the jitted hybrid-parallel train step.

  Args:
    loss_fn: ``(params, batch) -> (scalar_loss, aux_metrics)``. The loss
      must be a mean over the **global** batch.
    optimizer: optax transformation (possibly from ``multi_optimizer``).
    params_template: optional params pytree used to infer per-leaf
      shardings when ``comm_gradient_wire_dtype`` is set. When omitted,
      the template is taken from ``state.params`` at the first call (the
      concrete ``TrainState`` carries committed shardings) — the option
      never silently no-ops.

  Returns:
    ``step(state, batch) -> (state, metrics)`` jitted over the context
    mesh with state donation. When ``comm_gradient_wire_dtype`` is
    requested and world > 1, ``metrics['wire_grad']`` reports whether
    the compressed reduction is actually active for this step (``0.0``
    = fell back to the f32 GSPMD reduction because a params leaf is
    mesh-sharded — the structured sibling of the ``loss_exact`` flag).
  """
  ctx = ctx or Context.get()
  wire = _grad_wire_dtype()
  want_wire = wire is not None and ctx.world_size > 1
  donate = (0,) if donate_state else ()

  def build(template):
    grad_fn = None
    if want_wire and template is not None:
      grad_fn = make_wire_grad_fn(loss_fn, template, ctx, wire)

    def step(state: TrainState, batch):
      if grad_fn is not None:
        loss, aux, grads = grad_fn(state.params, batch)
      else:
        (loss, aux), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, batch)
      updates, opt_state = optimizer.update(grads, state.opt_state,
                                            state.params)
      params = optax.apply_updates(state.params, updates)
      new_state = TrainState(step=state.step + 1, params=params,
                             opt_state=opt_state)
      metrics = dict(aux)
      metrics['loss'] = loss
      if want_wire:
        metrics['wire_grad'] = jnp.float32(1.0 if grad_fn is not None
                                           else 0.0)
      return new_state, metrics

    return jax.jit(step, donate_argnums=donate)

  if not want_wire or params_template is not None:
    return build(params_template)
  return _FirstCallTemplatedStep(build)


class _FirstCallTemplatedStep:
  """Defers wire-grad-path construction until the first call supplies a
  concrete ``TrainState`` (whose params carry committed shardings).

  Keeps ``comm_gradient_wire_dtype`` working with zero extra arguments:
  ``make_train_step`` callers that never pass ``params_template`` still
  get the compressed reduction. Tracer params (a step built inside
  another trace) fall back to the GSPMD path for that build only.
  """

  def __init__(self, build):
    self._build = build
    self._compiled = None
    self._fallback = False  # True while _compiled came from a tracer call

  def _ensure(self, state):
    if self._compiled is not None and not self._fallback:
      return self._compiled   # settled: keep the per-step hot path free
                              # of a full pytree flatten + Tracer scan
    params = state.params
    traced = any(isinstance(l, jax.core.Tracer)
                 for l in jax.tree_util.tree_leaves(params))
    if self._compiled is None or (self._fallback and not traced):
      # A first call under a trace can't read shardings, so it builds
      # the GSPMD-only fallback — but only provisionally: the first
      # NON-tracer call rebuilds with the real template so wire
      # compression engages instead of latching off forever.
      self._compiled = self._build(None if traced else params)
      self._fallback = traced
    return self._compiled

  def __call__(self, state, batch):
    return self._ensure(state)(state, batch)

  def lower(self, state, batch):
    return self._ensure(state).lower(state, batch)


def make_eval_step(eval_fn: Callable[[Any, Dict[str, jax.Array]],
                                     Dict[str, jax.Array]],
                   ctx: Optional[Context] = None) -> Callable:
  """Build the jitted eval step: ``(params, batch) -> metrics updates``.

  Mirrors the reference's separate-eval-graph-in-same-session
  (``evaluation.py:111-327``) — in JAX simply a second jitted function
  over the same params.
  """
  ctx = ctx or Context.get()
  return jax.jit(eval_fn)


__all__ = ['TrainState', 'make_train_step', 'make_eval_step']
