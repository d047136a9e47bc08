"""Sharded embedding lookup strategies.

A JAX re-design of the reference's sharded-lookup rewriting
(``/root/reference/hybridbackend/tensorflow/embedding/sharding.py:168-278``).
The reference routes lookups as: modulo-partition ids → NCCL alltoallv →
unique → local gather → alltoallv embeddings back → stitch, with a
hierarchical (intra-node then inter-node) two-stage variant. Here the
same exchange is expressed with static shapes under ``shard_map``; three
strategies are provided (option ``emb_lookup_strategy``):

* ``allgather`` (default) — all-gather the (small, int32) ids across the
  mesh, gather owned rows locally with masking, and return results via
  ``reduce_scatter``. Every shape is static and the schedule is simple —
  but the wire cost is ``~(W-1)/W · B·D`` per device each way (HLO-
  counted: ``utils/hlo_bytes.py``), i.e. proportional to the GLOBAL
  batch. Best at small world sizes or tiny dims.
* ``alltoall`` — the literal PICASSO protocol: bucketed partition by
  owner shard → all_to_all ids (+sizes) → local gather → all_to_all
  embeddings back → unbucket. With ``emb_lookup_bucket_ratio`` r the
  payload is ``~r·(B/W)·D`` per device — a ``W/r`` wire win over
  allgather (the reference alltoallv's point); bucket overflow falls
  back to the exact full-capacity exchange.
* ``gspmd`` — plain ``jnp.take`` on the row-sharded global array; XLA's
  SPMD partitioner picks the exchange. Zero framework code in the hot
  path; useful as a baseline and for odd meshes.

Gradients flow through all strategies via JAX autodiff: the backward of
``psum_scatter`` is ``all_gather`` and vice versa, giving exactly the
reference's reverse-alltoallv gradient (``collective.py:334-347``) without
a hand-written VJP. Sharded-table gradients stay local to each shard
(never allreduced), matching ``gradient.py:197-207``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from hybridbackend_tpu.distribute.collective import (
    all_to_all_v_t, axis_index_t)
from hybridbackend_tpu.distribute.partition import partition_by_fn
from hybridbackend_tpu.embedding.table import TableConfig
from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.framework.options import OPTIONS


def lookup(table: jax.Array, ids: jax.Array, config: TableConfig,
           ctx: Optional[Context] = None,
           strategy: Optional[str] = None) -> jax.Array:
  """Look up ``ids`` (any shape) in a (possibly row-sharded) table.

  Returns embeddings of shape ``ids.shape + (dim,)``, batch-sharded like
  ``ids``. ``table`` may also be a :class:`~hybridbackend_tpu.embedding
  .quant.QuantizedTable` (int8 serving residency) — dequantized after
  the gather. Any flat size is accepted: sizes that do not divide the
  world evenly are auto-padded with ``-1`` (no owner shard → zero
  embeddings, zero grads) and sliced back — the reference's alltoallv
  takes arbitrary sizes (``nccl_alltoallv.cc:200-350``); the static-shape
  analogue is padding.
  """
  ctx = ctx or Context.get()

  from hybridbackend_tpu.embedding.quant import (
      QuantizedTable, lookup_quantized)
  if isinstance(table, QuantizedTable):
    return lookup_quantized(table, ids, config, ctx=ctx)

  if config.should_shard(ctx):
    n = 1
    for s in ids.shape:
      n *= s
    if n % ctx.world_size != 0:
      flat_ids0 = ids.reshape(-1)
      padded_n = -(-n // ctx.world_size) * ctx.world_size
      flat_p = jnp.concatenate(
          [flat_ids0, jnp.full((padded_n - n,), -1, flat_ids0.dtype)])
      out = lookup(table, flat_p, config, ctx=ctx, strategy=strategy)[:n]
      return out.reshape(*ids.shape, config.dim)

  # Dedup before the exchange (reference: tf.unique ahead of the local
  # gather, sharding.py:186-189): with ``emb_unique_ratio < 1`` the
  # exchange carries at most ratio·n unique ids — exact whenever the
  # true unique count fits the capacity, a direct payload shrink for
  # high-duplicate workloads (DIN behavior sequences). Runs on raw ids
  # (before row mixing, which is bijective) so the recursion maps rows
  # exactly once.
  ratio = float(OPTIONS.get_for('emb_unique_ratio', config.name))
  if ratio < 1.0 and config.should_shard(ctx):
    from hybridbackend_tpu.embedding.unique import unique as _unique
    flat_ids = ids.reshape(-1)
    cap = max(ctx.world_size,
              (int(round(flat_ids.shape[0] * ratio)) // ctx.world_size)
              * ctx.world_size)
    # Fill with -1 (invalid): pad lanes must not consume bucket capacity
    # in the downstream bucketed exchange, and every strategy zeros
    # invalid lanes.
    u = _unique(flat_ids, capacity=cap, fill_value=-1)
    with OPTIONS.override(emb_unique_ratio=1.0):
      emb_u = lookup(table, u.values, config, ctx=ctx, strategy=strategy)
      # Capacity overflow would silently alias surplus uniques to slot
      # cap-1 (the reference's tf.unique is always exact,
      # sharding.py:186-189) — fall back to the exact non-deduped
      # exchange when it trips. The predicate is a global scalar, so
      # every device takes the same branch and the collectives inside
      # stay uniform.
      exact = lambda: lookup(table, flat_ids, config, ctx=ctx,
                             strategy=strategy)
      deduped = lambda: jnp.take(emb_u, u.index, axis=0)
      out = jax.lax.cond(u.overflowed, exact, deduped)
    return out.reshape(*ids.shape, config.dim)

  rows = config.row_index(ids, ctx)
  # Validity is a LOGICAL-id property enforced for EVERY strategy here:
  # on shuffle_ids tables an out-of-vocab positive id mixes to a real
  # row, and on padded tables it can hit an initializer-filled padding
  # row — both would silently return (and backprop into) a live row.
  # Mapping invalid ids to -1 rides the no-owner-shard → zeros contract
  # every downstream path already implements.
  rows = jnp.where((ids >= 0) & (ids < config.vocab_size), rows, -1)

  p = config.pack_of(table)
  if p > 1:
    # Lane-packed table ([V/p, 128] physical; see emb_lane_pack): fetch
    # the packed row through the ordinary machinery, then select the
    # logical row's lane slice — a batch-sized mask, so the narrow
    # intermediate costs nothing (table-sized narrow arrays are what
    # XLA pads 128/d-fold).
    import dataclasses as _dc
    pcfg = _dc.replace(config, vocab_size=int(table.shape[0]),
                       dim=p * config.dim, shuffle_ids=False,
                       lane_pack=False, initializer=None)
    # Flatten multi-dim id batches ([B, K] stacked lookups) before the
    # lane select, so the select runs over a flat [B·K, p, d] view.
    frows = rows.reshape(-1)
    prows = jnp.where(frows >= 0, frows // p, frows)
    wide = lookup(table, prows, pcfg, ctx=ctx, strategy=strategy)
    lane = jnp.where(frows >= 0, (frows % p).astype(jnp.int32), 0)
    oh = (lane[..., None] == jnp.arange(p, dtype=jnp.int32)
          ).astype(wide.dtype)
    wide = wide.reshape(-1, p, config.dim)
    out = (wide * oh[..., None]).sum(-2).reshape(*rows.shape, config.dim)
    # Validity is a LOGICAL-id property: row mixing spreads ids over the
    # whole pow2-padded physical range, so an out-of-vocab id can land
    # on a real packed row — mask on the pre-mix id, not the row.
    valid = (ids >= 0) & (ids < config.vocab_size)
    return jnp.where(valid[..., None], out, 0)

  if not config.should_shard(ctx):
    # Replicated path honors the same contract as every sharded
    # strategy: out-of-range/negative ids (padding lanes, unadmitted
    # dynamic ids) read as zeros — plain jnp.take would wrap -1 to the
    # LAST row numpy-style. Validity is checked on the LOGICAL id: for
    # shuffle_ids tables the mixed row of a valid id may land anywhere
    # in [0, padded_vocab), including >= vocab_size.
    out = jnp.take(table, rows, axis=0, mode='fill', fill_value=0)
    valid = (ids >= 0) & (ids < config.vocab_size)
    return jnp.where(valid[..., None], out, 0)

  # Per-table strategy via the '*'-wildcard dict scope (the reference's
  # DictOption, options.py:183-225):
  #   hb.scope(emb_lookup_strategy={'user_id': 'alltoall', '*': 'allgather'})
  strategy = strategy or OPTIONS.get_for('emb_lookup_strategy', config.name)
  orig_shape = rows.shape
  flat = rows.reshape(-1)

  if config.partition == 'column':
    # Column-sharded (dim-axis) table: every device holds all rows of
    # its dim slice. all_gather the ids, gather each slice locally for
    # the WHOLE batch, then a tiled all_to_all hands every batch owner
    # its rows' remaining dim slices (BASELINE config #4: column-sharded
    # large-dim tables).
    fn = jax.shard_map(
        functools.partial(_lookup_column, axes=ctx.data_axes,
                          vocab=config.padded_vocab(ctx)),
        mesh=ctx.mesh,
        in_specs=(P(None, ctx.data_axes), P(ctx.data_axes)),
        out_specs=P(ctx.data_axes, None))
    return fn(table, flat).reshape(*orig_shape, config.dim)

  if strategy == 'gspmd':
    # Zero-fill out-of-range ids, matching the sharded strategies (an
    # unowned id contributes nothing). mode='fill' alone is not enough:
    # jnp.take wraps negative indices numpy-style before bounds-checking.
    out = jnp.take(table, flat, axis=0, mode='fill', fill_value=0)
    out = jnp.where((flat >= 0)[:, None], out, 0)
    return out.reshape(*orig_shape, config.dim)

  axes = ctx.data_axes
  world = ctx.world_size
  vocab = config.padded_vocab(ctx)
  rows_per_shard = vocab // world

  # Wire compression for the embedding payload exchange (reference
  # fp16-on-the-wire, nccl_alltoallv.cc:331-339 CastIn/CastOut): only
  # data-movement collectives are compressed — the allgather strategy's
  # psum_scatter REDUCES on the wire, so it stays at table precision.
  wire = OPTIONS['comm_wire_dtype']
  wire = None if wire in ('float32', '', None) else jnp.dtype(wire)

  # Bucketed (wire-proportional) exchange capacity: ceil(ratio·b/W) rows
  # per peer bucket instead of b — the whole point of the alltoall
  # strategies (reference alltoallv moves exactly-sized payloads,
  # nccl_alltoallv.cc:200-350). Overflow falls back to the exact
  # full-capacity exchange under a globally-uniform predicate.
  import math
  b_local = flat.shape[0] // world
  bratio = float(OPTIONS.get_for('emb_lookup_bucket_ratio', config.name))
  fallback = bool(OPTIONS['emb_lookup_overflow_fallback'])

  def _cap(buckets: int) -> Optional[int]:
    if bratio <= 0:
      return None
    c = max(1, int(math.ceil(bratio * b_local / buckets)))
    return c if c < b_local else None

  if strategy == 'allgather':
    body = functools.partial(_lookup_allgather, axes=axes,
                             rows_per_shard=rows_per_shard)
  elif strategy == 'alltoall':
    body = functools.partial(_lookup_alltoall, axes=axes, world=world,
                             rows_per_shard=rows_per_shard, wire=wire,
                             cap=_cap(world), fallback=fallback)
  elif strategy == 'hierarchical':
    if len(axes) != 2:
      raise ValueError('hierarchical lookup needs a 2-axis (dcn, ici) mesh')
    ici_size = ctx.mesh.shape[axes[1]]
    dcn_size = ctx.mesh.shape[axes[0]]
    body = functools.partial(
        _lookup_hierarchical, dcn_axis=axes[0], ici_axis=axes[1],
        dcn_size=dcn_size, ici_size=ici_size,
        rows_per_shard=rows_per_shard, wire=wire,
        cap0=_cap(ici_size), cap1=_cap(dcn_size), fallback=fallback)
  else:
    raise ValueError(f'Unknown lookup strategy: {strategy!r}')

  fn = jax.shard_map(
      body, mesh=ctx.mesh,
      in_specs=(P(axes, None), P(axes)),
      out_specs=P(axes, None))
  out = fn(table, flat)
  return out.reshape(*orig_shape, config.dim)


def _lookup_column(shard, ids_local, *, axes, vocab):
  """Column-sharded lookup: shard is ``[V, dim/W]``.

  all_gather ids → local gather of this device's dim slice for ALL ids
  → tiled all_to_all redistributes so each device ends with its own
  batch rows × the full dim (slices concatenated in device order, which
  matches the global column order of ``P(None, axes)``)."""
  all_ids = jax.lax.all_gather(ids_local, axes, tiled=True)   # [B]
  valid = (all_ids >= 0) & (all_ids < vocab)
  emb = jnp.take(shard, jnp.clip(all_ids, 0, shard.shape[0] - 1),
                 axis=0)                                      # [B, d/W]
  emb = jnp.where(valid[:, None], emb, 0)
  return jax.lax.all_to_all(emb, axes, split_axis=0, concat_axis=1,
                            tiled=True)                       # [b, d]


def _lookup_allgather(shard, ids_local, *, axes, rows_per_shard):
  """all_gather ids → masked local gather → reduce_scatter embeddings."""
  me = axis_index_t(axes)
  all_ids = jax.lax.all_gather(ids_local, axes)          # [W, b]
  owner = all_ids // rows_per_shard
  local = all_ids - owner * rows_per_shard
  local = jnp.clip(local, 0, shard.shape[0] - 1)
  owned = (owner == me)[..., None]
  contrib = jnp.where(owned, jnp.take(shard, local, axis=0,
                                      mode='clip'), 0)   # [W, b, D]
  contrib = contrib.astype(shard.dtype)
  return jax.lax.psum_scatter(contrib, axes, scatter_dimension=0,
                              tiled=False)               # [b, D]


def _wire(x, wire):
  return x if wire is None else x.astype(wire)


def _unbucket(flat_payload, restore):
  """Unbucket with clip: discarded/overflow lanes carry an out-of-range
  restore position; their (garbage) values must be masked by the
  caller."""
  return jnp.take(flat_payload,
                  jnp.minimum(restore, flat_payload.shape[0] - 1), axis=0)


def _a2a_round_trip(shard, part, *, axes, me, rows_per_shard, wire):
  """Ship bucketed ids to owners, gather, ship embeddings back,
  unbucket. Payload volume is ``[W, cap]`` ids out / ``[W, cap, D]``
  embeddings back — wire-proportional when ``cap < b``."""
  recv, recv_sizes = all_to_all_v_t(part.buckets, part.sizes, axes)
  local = jnp.clip(recv - me * rows_per_shard, 0, rows_per_shard - 1)
  emb = jnp.take(shard, local, axis=0, mode='clip')      # [W, cap, D]
  back, _ = all_to_all_v_t(_wire(emb, wire), recv_sizes, axes)
  flat = back.astype(shard.dtype).reshape(-1, shard.shape[1])
  return _unbucket(flat, part.restore)                   # [b, D]


def _lookup_alltoall(shard, ids_local, *, axes, world, rows_per_shard,
                     wire=None, cap=None, fallback=True):
  """Bucketed-partition → a2a ids → local gather → a2a embeddings back.

  Static-shape translation of the reference exchange
  (``sharding.py:171-205`` / ``nccl_alltoallv.cc:200-350``). With
  ``cap`` set (``emb_lookup_bucket_ratio``), each device ships only
  ``[W, cap]`` ids and receives ``[W, cap, D]`` embeddings — a
  ``b/(W·cap)`` wire shrink vs. the allgather volume; bucket overflow
  re-routes the step through the exact full-capacity exchange under a
  globally-uniform predicate.
  """
  me = axis_index_t(axes)
  b = ids_local.shape[0]
  owner = ids_local // rows_per_shard
  valid = (owner >= 0) & (owner < world)
  shard_fn = lambda x: jnp.clip(x // rows_per_shard, 0, world - 1)

  def run(capacity):
    part = partition_by_fn(ids_local, world, shard_fn, capacity=capacity,
                           fill_value=-1, valid=valid)
    return part

  if cap is None or cap >= b:
    out = _a2a_round_trip(shard, run(None), axes=axes, me=me,
                          rows_per_shard=rows_per_shard, wire=wire)
    return jnp.where(valid[:, None], out, 0)
  part = run(cap)
  if fallback:
    pred = jax.lax.psum(part.overflow.astype(jnp.int32), axes) > 0
    out = jax.lax.cond(
        pred,
        lambda _: _a2a_round_trip(shard, run(None), axes=axes, me=me,
                                  rows_per_shard=rows_per_shard, wire=wire),
        lambda _: _a2a_round_trip(shard, part, axes=axes, me=me,
                                  rows_per_shard=rows_per_shard, wire=wire),
        None)
  else:
    out = _a2a_round_trip(shard, part, axes=axes, me=me,
                          rows_per_shard=rows_per_shard, wire=wire)
  return jnp.where(valid[:, None], out, 0)


def _hier_pipeline(shard, ids_local, valid, *, dcn_axis, ici_axis,
                   dcn_size, ici_size, world, rows_per_shard, me,
                   wire, cap0, cap1):
  """One hierarchical round trip at the given stage capacities.

  Returns ``(embeddings [b, D], overflow flag)``.
  """
  d = shard.shape[1]
  clip_owner = lambda x: jnp.clip(x // rows_per_shard, 0, world - 1)

  # Stage 0 (ICI): route each id to the local device whose ici position
  # matches the owner's ici position.
  p0 = partition_by_fn(ids_local, ici_size,
                       lambda x: clip_owner(x) % ici_size,
                       capacity=cap0, fill_value=-1, valid=valid)
  r0, s0 = all_to_all_v_t(p0.buckets, p0.sizes, ici_axis)   # [ici, cap0]
  ids1 = r0.reshape(-1)

  # Stage 1 (DCN): route to the owner's dcn position. Fill lanes from
  # stage 0 (-1) are discarded, not bucketed.
  p1 = partition_by_fn(ids1, dcn_size,
                       lambda x: clip_owner(x) // ici_size,
                       capacity=cap1, fill_value=-1, valid=ids1 >= 0)
  r1, s1 = all_to_all_v_t(p1.buckets, p1.sizes, dcn_axis)   # [dcn, cap1]

  # Local gather on the owner shard.
  local = jnp.clip(r1 - me * rows_per_shard, 0, rows_per_shard - 1)
  emb1 = jnp.take(shard, local, axis=0, mode='clip')        # [dcn, cap1, D]

  # Reverse stage 1 (DCN) then reverse stage 0 (ICI); the payload rides
  # both hops in the wire dtype.
  b1, _ = all_to_all_v_t(_wire(emb1, wire), s1, dcn_axis)
  emb_ids1 = _unbucket(b1.astype(shard.dtype).reshape(-1, d), p1.restore)
  emb0 = emb_ids1.reshape(ici_size, -1, d)                  # [ici, cap0, D]
  b0, _ = all_to_all_v_t(_wire(emb0, wire), s0, ici_axis)
  out = _unbucket(b0.astype(shard.dtype).reshape(-1, d), p0.restore)
  return out, p0.overflow | p1.overflow


def _lookup_hierarchical(shard, ids_local, *, dcn_axis, ici_axis,
                         dcn_size, ici_size, rows_per_shard, wire=None,
                         cap0=None, cap1=None, fallback=True):
  """Two-stage topology-aware exchange (reference ``sharding.py:207-278``,
  dual-modulo): ids travel (a,b) --ICI--> (a,b') --DCN--> (a',b') where
  the owner device of a row is (a', b'). The intra-node hop rides ICI
  bandwidth; only owner-column traffic crosses DCN — the reference's
  hierarchical alltoallv. Both hops use ``emb_lookup_bucket_ratio``
  static-capacity buckets with the exact full-capacity fallback on
  overflow.
  """
  world = dcn_size * ici_size
  my_dcn = jax.lax.axis_index(dcn_axis)
  me = my_dcn * ici_size + jax.lax.axis_index(ici_axis)

  owner = ids_local // rows_per_shard
  valid = (owner >= 0) & (owner < world)
  kw = dict(dcn_axis=dcn_axis, ici_axis=ici_axis, dcn_size=dcn_size,
            ici_size=ici_size, world=world, rows_per_shard=rows_per_shard,
            me=me, wire=wire)

  bucketed = cap0 is not None or cap1 is not None
  out, ovf = _hier_pipeline(shard, ids_local, valid, cap0=cap0, cap1=cap1,
                            **kw)
  if bucketed and fallback:
    pred = jax.lax.psum(ovf.astype(jnp.int32), (dcn_axis, ici_axis)) > 0
    out = jax.lax.cond(
        pred,
        lambda _: _hier_pipeline(shard, ids_local, valid, cap0=None,
                                 cap1=None, **kw)[0],
        lambda _: out,
        None)
  return jnp.where(valid[:, None], out, 0)


def lookup_sparse(table: jax.Array, ids: jax.Array, mask: jax.Array,
                  config: TableConfig,
                  weights: Optional[jax.Array] = None,
                  combiner: Optional[str] = None,
                  ctx: Optional[Context] = None,
                  strategy: Optional[str] = None) -> jax.Array:
  """Combined lookup over padded ragged ids (embedding_lookup_sparse).

  Args:
    ids: ``[batch, max_len]`` padded id matrix.
    mask: ``[batch, max_len]`` validity mask (bool or 0/1).
    weights: optional per-id weights.
    combiner: sum | mean | sqrtn (reference
      ``tf.nn.embedding_lookup_sparse`` parity).

  Returns:
    ``[batch, dim]`` combined embeddings.
  """
  combiner = combiner or config.combiner
  emb = lookup(table, ids, config, ctx=ctx, strategy=strategy)
  m = mask.astype(emb.dtype)
  if weights is not None:
    m = m * weights.astype(emb.dtype)
  emb = emb * m[..., None]
  total = jnp.sum(emb, axis=-2)
  if combiner == 'sum':
    return total
  denom = jnp.sum(m, axis=-1, keepdims=True)
  if combiner == 'mean':
    return total / jnp.maximum(denom, 1e-9)
  if combiner == 'sqrtn':
    return total / jnp.sqrt(jnp.maximum(denom, 1e-9))
  raise ValueError(f'Unknown combiner: {combiner!r}')


__all__ = ['lookup', 'lookup_sparse']
