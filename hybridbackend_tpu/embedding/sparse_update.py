"""Row-sparse embedding-table updates.

The JAX form of the reference's sparse gradient path: sharded
embedding gradients arrive as ``IndexedSlices`` and are applied directly
to the touched rows (``/root/reference/hybridbackend/tensorflow/training/
gradient.py:197-207`` — sharded grads bypass aggregation; the optimizer's
sparse ``apply`` touches only those rows).

With plain autodiff + optax, a table gradient materializes as a dense
``[V, D]`` array and the optimizer update reads+writes the WHOLE table
every step; the row-sparse path below moves only the touched rows.

The entry point is :func:`sparse_adagrad_apply` (and SGD variant): given
the batch's ids and the gradient w.r.t. the looked-up embeddings
(``demb``), it updates only the touched rows — including the collective
routing of ``demb`` back to owner shards for sharded tables (the same
all_gather the autodiff backward would issue, without the dense
scatter).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from hybridbackend_tpu.distribute.collective import axis_index_t
from hybridbackend_tpu.embedding.table import TableConfig
from hybridbackend_tpu.embedding.unique import unique
from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register(
    'emb_update_exchange', 'alltoall', env='HB_EMB_UPDATE_EXCHANGE',
    doc="Gradient-return exchange for row-sharded tables: 'alltoall' "
        "(default; bucketed owner-routed exchange — bytes per device "
        '∝ its local batch, the static-shape form of the reference '
        "reverse alltoallv, collective.py:326-350) or 'allgather' (every "
        'device receives the full [W*b, D] payload — W× the wire '
        'bytes, only sensible for tiny batches).')
OPTIONS.register(
    'emb_update_bucket_ratio', 2.0, env='HB_EMB_UPDATE_BUCKET_RATIO',
    doc='Capacity slack of the alltoall update exchange: per-peer bucket '
        'capacity = ratio * ceil(local_batch / world). '
        'Balanced id mixing concentrates per-owner unique counts near '
        'the mean, so 2.0 has huge headroom; overflow never corrupts — '
        'see emb_update_overflow_fallback.')
OPTIONS.register(
    'emb_update_overflow_fallback', True,
    env='HB_EMB_UPDATE_OVERFLOW_FALLBACK',
    doc='When an alltoall update bucket overflows, re-route that step '
        'through the lossless allgather exchange (a lax.cond on a '
        'globally-uniform flag; both branches compile, only one runs). '
        'Disabling drops overflow gradients — only for benchmarking.')


def _valid_rows(rows, ids, config: TableConfig):
  """Same logical-id validity contract as ``lookup``: out-of-vocab
  positive ids must not resolve to a real (mixed or padding) row — for
  LazyAdam even a zero-gradient touch decays a row's moments."""
  return jnp.where((ids >= 0) & (ids < config.vocab_size), rows, -1)


class SparseOptState(NamedTuple):
  """Per-table slot state (Adagrad accumulator; empty tuple for SGD)."""
  acc: Tuple[jax.Array, ...]


# ---------------------------------------------------------------------------
# Gradient-return exchange for row-sharded tables.
#
# The reference returns sparse gradients to owner shards with a REVERSE
# alltoallv — bytes ∝ the local batch (collective.py:326-350,
# sharding.py:171-205). The static-shape form below: locally combine
# duplicate rows, bucket (row, grad-total) pairs by owner shard with a
# static capacity, exchange via all_to_all_v_t, and let the owner apply
# the update. The legacy allgather route ships the full [W*b, D] payload
# to every device (W x the wire bytes) and remains as the lossless
# fallback when a bucket overflows.
# ---------------------------------------------------------------------------


def _pad_to_world(rows: jax.Array, g: jax.Array, world: int
                  ) -> Tuple[jax.Array, jax.Array]:
  """Pad (rows, grads) to a world multiple with (-1, 0) lanes so the
  batch axis splits evenly under shard_map (parity with the lookup's
  arbitrary-size contract; -1 rows own no shard and are dropped)."""
  n = rows.shape[0]
  if world <= 1 or n % world == 0:
    return rows, g
  pn = -(-n // world) * world
  rows = jnp.concatenate([rows, jnp.full((pn - n,), -1, rows.dtype)])
  g = jnp.concatenate([g, jnp.zeros((pn - n,) + g.shape[1:], g.dtype)])
  return rows, g


def _local_combine(rows: jax.Array, g: jax.Array
                   ) -> Tuple[jax.Array, jax.Array]:
  """Sum duplicate rows' grads locally (exact row-total semantics).

  Returns ``(urows [n], gsum [n, D])``: unique rows in ascending order in
  a prefix, ``-1`` in unused lanes. Invalid input rows (``< 0``) collapse
  into the ``-1`` lane, which the owner-side update drops.
  """
  n, d = g.shape
  order = jnp.argsort(rows)
  srows = rows[order]
  sg = g[order]
  is_first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                              srows[1:] != srows[:-1]])
  slot = jnp.cumsum(is_first.astype(jnp.int32)) - 1
  gsum = jnp.zeros((n, d), g.dtype).at[slot].add(sg)
  urows = jnp.full((n,), -1, rows.dtype).at[slot].set(srows)
  return urows, gsum


def _bucket_by_owner(urows: jax.Array, gsum: jax.Array, world: int,
                     rows_per_shard: int, cap: int):
  """Bucket (row, grad) pairs by owner shard with static capacity.

  Returns ``(id_buckets [W, cap], g_buckets [W, cap, D], sizes [W],
  overflow)``; padding lanes carry row ``-1`` / zero grads. Rows outside
  ``[0, W*rows_per_shard)`` are discarded (they own no shard — same
  contract as the lookup strategies).
  """
  n, d = gsum.shape
  vocab = world * rows_per_shard
  shard = jnp.where((urows >= 0) & (urows < vocab),
                    (urows // rows_per_shard).astype(jnp.int32),
                    jnp.int32(world))                  # world = discard
  order = jnp.argsort(shard, stable=True)
  s_shard = shard[order]
  s_rows = urows[order]
  s_g = gsum[order]
  counts = jnp.bincount(shard, length=world + 1).astype(jnp.int32)
  starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts)[:-1].astype(jnp.int32)])
  pos = jnp.arange(n, dtype=jnp.int32) - starts[s_shard]
  ok = (pos < cap) & (s_shard < world)
  flat = jnp.where(ok, s_shard * cap + pos, world * cap)   # oob -> dropped
  id_buckets = jnp.full((world * cap,), -1, urows.dtype)
  id_buckets = id_buckets.at[flat].set(
      jnp.where(ok, s_rows, -1), mode='drop')
  g_buckets = jnp.zeros((world * cap, d), gsum.dtype)
  g_buckets = g_buckets.at[flat].set(
      jnp.where(ok[:, None], s_g, 0), mode='drop')
  overflow = jnp.any(counts[:world] > cap)
  sizes = jnp.minimum(counts[:world], cap)
  return (id_buckets.reshape(world, cap),
          g_buckets.reshape(world, cap, d), sizes, overflow)


def _grad_wire():
  w = OPTIONS['comm_gradient_wire_dtype']
  return None if w in ('float32', '', None) else jnp.dtype(w)


def _update_bucket_cap(n_local: int, world: int) -> int:
  ratio = float(OPTIONS['emb_update_bucket_ratio'])
  import math
  cap = int(math.ceil(ratio * math.ceil(n_local / world)))
  return max(1, min(n_local, cap))


def _route_grads_a2a(rows_local, g_local, *, axes, world, rows_per_shard,
                     cap, combine=True):
  """In-spmd: route local (row, grad) pairs to their owner shards.

  Returns ``(local_rows [W*cap] with -1 invalid lanes,
  grads [W*cap, D], overflow flag)`` — the owner-relative row ids and
  per-row grad totals this shard must apply. ``combine=False`` ships
  per-occurrence pairs uncombined (TF nodedup semantics need every
  occurrence's grad at the owner).
  """
  from hybridbackend_tpu.distribute.collective import all_to_all_v_t
  if combine:
    urows, gsum = _local_combine(rows_local, g_local)
  else:
    urows, gsum = rows_local, g_local
  idb, gb, sizes, ovf = _bucket_by_owner(urows, gsum, world,
                                         rows_per_shard, cap)
  recv_ids, _ = all_to_all_v_t(idb, sizes, axes)
  recv_g, _ = all_to_all_v_t(gb, sizes, axes, wire_dtype=_grad_wire())
  me = axis_index_t(axes)
  local = jnp.where(recv_ids >= 0, recv_ids - me * rows_per_shard, -1)
  d = g_local.shape[1]
  return (local.reshape(-1),
          recv_g.astype(g_local.dtype).reshape(-1, d), ovf)


def _route_grads_allgather(rows_local, g_local, *, axes, world,
                           rows_per_shard):
  """In-spmd: legacy full-payload route — every device receives the
  whole ``[W*b, D]`` gradient and masks to its owned rows."""
  me = axis_index_t(axes)
  all_ids = jax.lax.all_gather(rows_local, axes, tiled=True)    # [W*b]
  all_g = jax.lax.all_gather(g_local, axes, tiled=True)         # [W*b, D]
  owner = all_ids // rows_per_shard
  mine = (owner == me) & (all_ids >= 0)
  local = jnp.where(mine, all_ids - me * rows_per_shard, -1)
  return local, jnp.where(mine[:, None], all_g, 0)


def _rowsharded_update(table, slots, rows_b, demb, apply_local, *,
                       ctx: Context, combine: bool = True):
  """Shared row-sharded update driver: route grads to owners, apply.

  Args:
    slots: tuple of slot-state arrays co-sharded with ``table``.
    apply_local: ``(shard, slot_shards, local_rows, grads) ->
      (shard', slot_shards')`` where ``local_rows`` uses ``-1`` for
      invalid lanes. Runs inside shard_map on owner shards.
    combine: pre-sum duplicate rows' grads before the exchange (exact
      for row-total semantics; must be False for TF per-occurrence
      nodedup semantics).
  """
  axes = ctx.data_axes
  world = ctx.world_size
  rows_per_shard = table.shape[0] // world
  exchange = OPTIONS['emb_update_exchange']
  fallback = bool(OPTIONS['emb_update_overflow_fallback'])
  n_local = rows_b.shape[0] // world
  cap = _update_bucket_cap(n_local, world)

  def body(shard, slot_shards, ids_local, demb_local):
    if exchange == 'alltoall':
      local, g, ovf = _route_grads_a2a(
          ids_local, demb_local, axes=axes, world=world,
          rows_per_shard=rows_per_shard, cap=cap, combine=combine)
      if not fallback:
        return apply_local(shard, slot_shards, local, g)
      # Globally-uniform overflow predicate: every device takes the
      # same branch, so the collectives inside stay uniform.
      pred = jax.lax.psum(ovf.astype(jnp.int32), axes) > 0

      def via_allgather(args):
        shard_, slots_ = args
        l2, g2 = _route_grads_allgather(
            ids_local, demb_local, axes=axes, world=world,
            rows_per_shard=rows_per_shard)
        return apply_local(shard_, slots_, l2, g2)

      def via_a2a(args):
        shard_, slots_ = args
        return apply_local(shard_, slots_, local, g)

      return jax.lax.cond(pred, via_allgather, via_a2a,
                          (shard, slot_shards))
    local, g = _route_grads_allgather(
        ids_local, demb_local, axes=axes, world=world,
        rows_per_shard=rows_per_shard)
    return apply_local(shard, slot_shards, local, g)

  nslots = len(slots)
  fn = jax.shard_map(
      body, mesh=ctx.mesh,
      in_specs=(P(axes, None), (P(axes, None),) * nslots,
                P(axes), P(axes, None)),
      out_specs=(P(axes, None), (P(axes, None),) * nslots),
      check_vma=False)
  return fn(table, tuple(slots), rows_b, demb)


def init_adagrad_state(table: jax.Array,
                       initial: float = 0.1) -> SparseOptState:
  """Accumulator co-sharded with the table (same global shape)."""
  acc = jax.jit(lambda t: jnp.full_like(t, initial),
                out_shardings=table.sharding if hasattr(table, 'sharding')
                else None)(table)
  return SparseOptState(acc=(acc,))


def _dedup_grads(ids: jax.Array, demb: jax.Array,
                 oob_row: int) -> Tuple[jax.Array, jax.Array]:
  """Combine duplicate ids: Adagrad must square the per-row TOTAL grad.

  Returns (unique_rows [n], summed grads [n, D]); padding slots map to
  ``oob_row`` so a mode='drop' scatter ignores them.
  """
  u = unique(ids, fill_value=-1)
  n, d = demb.shape[0], demb.shape[1]
  gsum = jnp.zeros((n, d), demb.dtype).at[u.index].add(demb)
  slot_valid = jnp.arange(n) < u.count
  rows = jnp.where(slot_valid & (u.values >= 0), u.values, oob_row)
  return rows, gsum


def _adagrad_rows(table, acc, rows, gsum, lr, eps):
  """Apply Adagrad to `rows` only (mode='drop' skips out-of-range)."""
  acc = acc.at[rows].add(gsum * gsum, mode='drop')
  denom = jnp.sqrt(jnp.take(acc, rows, axis=0, mode='fill',
                            fill_value=1.0)) + eps
  table = table.at[rows].add(-lr * gsum / denom, mode='drop')
  return table, acc


def _adagrad_rows_nodedup(table, acc, rows, g, lr, eps, oob_row):
  """Adagrad without duplicate combining (TF ``SparseApplyAdagrad``
  semantics: duplicate ids accumulate per-occurrence squared grads; the
  denominator is read after ALL squares land, so the result is
  deterministic). Skips the sort-based ``unique`` — one scatter-add, one
  gather, one scatter-add, all O(n)."""
  safe = jnp.where((rows >= 0) & (rows < table.shape[0]), rows, oob_row)
  acc = acc.at[safe].add(g * g, mode='drop')
  denom = jnp.sqrt(jnp.take(acc, safe, axis=0, mode='fill',
                            fill_value=1.0)) + eps
  table = table.at[safe].add(-lr * g / denom, mode='drop')
  return table, acc


def _sgd_rows(table, rows, gsum, lr):
  return table.at[rows].add(-lr * gsum, mode='drop')


def _pack_expand(rows: jax.Array, updates: jax.Array, p: int
                 ) -> Tuple[jax.Array, jax.Array]:
  """Packed row ``r//p`` of each logical row ``r``, and its ``[N, d]``
  update placed in lane slice ``(r%p)·d`` of an ``[N, p·d]`` array.
  Negative (invalid) rows stay negative."""
  n, d = updates.shape
  prow = jnp.where(rows >= 0, rows // p, rows)
  lane = jnp.where(rows >= 0, (rows % p).astype(jnp.int32), 0)
  oh = (lane[:, None] == jnp.arange(p, dtype=jnp.int32)[None, :]
        ).astype(updates.dtype)
  upd = (oh[:, :, None] * updates[:, None, :]).reshape(n, p * d)
  return prow, upd


def _maybe_lane_pack(rows_b, demb, config: TableConfig, table, p: int):
  """Map (logical rows, [N, d] grads) into a lane-packed table's space:
  packed rows ``r//p`` and grads expanded into lane slice ``(r%p)·d``
  (see ``TableConfig.pack_of`` / ``emb_lane_pack``). Returns the
  possibly-updated ``(rows, grads, config)`` — downstream code then
  operates on the PHYSICAL [V/p, 128] geometry uniformly (vocab taken
  from the concrete array: the layout is creation-time-fixed). Exact
  for add/adagrad: logical rows sharing a packed row occupy disjoint
  lanes."""
  if p <= 1:
    return rows_b, demb, config
  import dataclasses as _dc
  rows_b, demb = _pack_expand(rows_b, demb, p)
  pcfg = _dc.replace(config, vocab_size=int(table.shape[0]),
                     dim=p * config.dim, shuffle_ids=False,
                     lane_pack=False, initializer=None)
  return rows_b, demb, pcfg


def sparse_adagrad_apply(table: jax.Array, state: SparseOptState,
                         ids: jax.Array, demb: jax.Array,
                         config: TableConfig, lr: float,
                         eps: float = 1e-7,
                         dedup: bool = True,
                         ctx: Optional[Context] = None
                         ) -> Tuple[jax.Array, SparseOptState]:
  """Adagrad on touched rows only.

  Args:
    ids: the batch's (flattened) lookup ids, batch-sharded.
    demb: gradient of the loss w.r.t. the looked-up embeddings,
      same leading shape as ``ids``.
    dedup: combine duplicate ids before squaring (exact Adagrad). With
      ``False``, duplicates accumulate per-occurrence squares (TF
      ``SparseApplyAdagrad`` semantics) and the sort-based ``unique`` is
      skipped.
  """
  ctx = ctx or Context.get()
  rows_b = _valid_rows(config.row_index(ids.reshape(-1), ctx),
                       ids.reshape(-1), config)
  demb = demb.reshape(-1, demb.shape[-1]).astype(table.dtype)
  # The pack factor follows the CONCRETE array (pack_of), not ctx: a
  # serving/restore context must not re-decide the layout.
  rows_b, demb, config = _maybe_lane_pack(rows_b, demb, config, table,
                                          config.pack_of(table))
  rows_b, demb = _pad_to_world(rows_b, demb, ctx.world_size)
  acc = state.acc[0]

  if not config.should_shard(ctx):
    # Replicated table: every replica applies the GLOBAL per-row grad.
    # Gather grads across the mesh (parity with the reference's
    # allgatherv of replicated sparse grads, gradient.py:163-177).
    if ctx.world_size > 1:
      def body(r, g):
        all_r = jax.lax.all_gather(r, ctx.data_axes, tiled=True)
        all_g = jax.lax.all_gather(g, ctx.data_axes, tiled=True)
        return all_r, all_g
      rows_b, demb = jax.shard_map(
          body, mesh=ctx.mesh,
          in_specs=(P(ctx.data_axes), P(ctx.data_axes, None)),
          out_specs=(P(), P()), check_vma=False)(rows_b, demb)
    if dedup:
      rows, gsum = _dedup_grads(rows_b, demb, oob_row=table.shape[0])
      table, acc = _adagrad_rows(table, acc, rows, gsum, lr, eps)
    else:
      table, acc = _adagrad_rows_nodedup(table, acc, rows_b, demb, lr,
                                         eps, oob_row=table.shape[0])
    return table, SparseOptState(acc=(acc,))

  axes = ctx.data_axes
  if config.partition == 'column':
    # Column-sharded table: every device owns ALL rows of its dim
    # slice. all_gather the ids; the inverse of the lookup's all_to_all
    # hands each device the full batch's gradients for its slice.
    vocab_c = config.padded_vocab(ctx)

    def body_c(shard, acc_shard, ids_local, demb_local):
      all_ids = jax.lax.all_gather(ids_local, axes, tiled=True)   # [B]
      slice_g = jax.lax.all_to_all(demb_local, axes, split_axis=1,
                                   concat_axis=0, tiled=True)  # [B, d/W]
      if dedup:
        rows, gsum = _dedup_grads(all_ids, slice_g, oob_row=vocab_c)
        return _adagrad_rows(shard, acc_shard, rows, gsum, lr, eps)
      return _adagrad_rows_nodedup(shard, acc_shard, all_ids, slice_g,
                                   lr, eps, oob_row=vocab_c)

    fn = jax.shard_map(
        body_c, mesh=ctx.mesh,
        in_specs=(P(None, axes), P(None, axes), P(axes), P(axes, None)),
        out_specs=(P(None, axes), P(None, axes)), check_vma=False)
    table, acc = fn(table, acc, rows_b, demb)
    return table, SparseOptState(acc=(acc,))

  rows_per_shard = config.padded_vocab(ctx) // ctx.world_size

  def apply_local(shard, slot_shards, local, g):
    (acc_shard,) = slot_shards
    safe = jnp.where(local >= 0, local, rows_per_shard)   # oob -> dropped
    if dedup:
      rows, gsum = _dedup_grads(safe, g, oob_row=rows_per_shard)
      t, a = _adagrad_rows(shard, acc_shard, rows, gsum, lr, eps)
    else:
      t, a = _adagrad_rows_nodedup(shard, acc_shard, safe, g, lr, eps,
                                   oob_row=rows_per_shard)
    return t, (a,)

  table, (acc,) = _rowsharded_update(
      table, (acc,), rows_b, demb, apply_local, ctx=ctx,
      combine=dedup)
  return table, SparseOptState(acc=(acc,))


def sparse_sgd_apply(table: jax.Array, ids: jax.Array, demb: jax.Array,
                     config: TableConfig, lr: float,
                     ctx: Optional[Context] = None) -> jax.Array:
  """SGD on touched rows only (no slot state)."""
  ctx = ctx or Context.get()
  rows_b = _valid_rows(config.row_index(ids.reshape(-1), ctx),
                       ids.reshape(-1), config)
  demb = demb.reshape(-1, demb.shape[-1]).astype(table.dtype)
  rows_b, demb, config = _maybe_lane_pack(rows_b, demb, config, table,
                                          config.pack_of(table))
  rows_b, demb = _pad_to_world(rows_b, demb, ctx.world_size)

  if not config.should_shard(ctx):
    if ctx.world_size > 1:
      def gather(r, g):
        return (jax.lax.all_gather(r, ctx.data_axes, tiled=True),
                jax.lax.all_gather(g, ctx.data_axes, tiled=True))
      rows_b, demb = jax.shard_map(
          gather, mesh=ctx.mesh,
          in_specs=(P(ctx.data_axes), P(ctx.data_axes, None)),
          out_specs=(P(), P()), check_vma=False)(rows_b, demb)
    oob = table.shape[0]
    safe = jnp.where((rows_b >= 0) & (rows_b < oob), rows_b, oob)
    return table.at[safe].add(-lr * demb, mode='drop')

  if config.partition == 'column':
    axes = ctx.data_axes
    vocab_c = config.padded_vocab(ctx)

    def body_c(shard, ids_local, demb_local):
      all_ids = jax.lax.all_gather(ids_local, axes, tiled=True)
      slice_g = jax.lax.all_to_all(demb_local, axes, split_axis=1,
                                   concat_axis=0, tiled=True)
      safe = jnp.where((all_ids >= 0) & (all_ids < vocab_c), all_ids,
                       vocab_c)
      return _sgd_rows(shard, safe, slice_g, lr)

    return jax.shard_map(
        body_c, mesh=ctx.mesh,
        in_specs=(P(None, axes), P(axes), P(axes, None)),
        out_specs=P(None, axes), check_vma=False)(table, rows_b, demb)

  rows_per_shard = config.padded_vocab(ctx) // ctx.world_size

  def apply_local(shard, slot_shards, local, g):
    del slot_shards
    safe = jnp.where(local >= 0, local, rows_per_shard)
    return _sgd_rows(shard, safe, g, lr), ()

  table, _ = _rowsharded_update(table, (), rows_b, demb, apply_local,
                                ctx=ctx)
  return table


__all__ = ['SparseOptState', 'init_adagrad_state', 'init_adam_state',
           'sparse_adagrad_apply', 'sparse_adam_apply',
           'sparse_sgd_apply']


def _adam_rows(table, m, v, rows, gsum, lr, step, b1, b2, eps):
  """LazyAdam on unique `rows` (mode='drop' skips out-of-range):
  moments decay only for the supplied rows."""
  t = jnp.asarray(step, jnp.float32)
  bc1 = 1.0 - jnp.asarray(b1, jnp.float32) ** t
  bc2 = 1.0 - jnp.asarray(b2, jnp.float32) ** t
  m_rows = jnp.take(m, rows, axis=0, mode='fill', fill_value=0.0)
  v_rows = jnp.take(v, rows, axis=0, mode='fill', fill_value=0.0)
  m_new = b1 * m_rows + (1 - b1) * gsum
  v_new = b2 * v_rows + (1 - b2) * gsum * gsum
  m = m.at[rows].set(m_new, mode='drop')
  v = v.at[rows].set(v_new, mode='drop')
  upd = lr * (m_new / bc1) / (jnp.sqrt(v_new / bc2) + eps)
  table = table.at[rows].add(-upd, mode='drop')
  return table, m, v


def init_adam_state(table: jax.Array) -> SparseOptState:
  """Adam moment slots co-sharded with the table."""
  zeros = jax.jit(jnp.zeros_like,
                  out_shardings=table.sharding
                  if hasattr(table, 'sharding') else None)
  return SparseOptState(acc=(zeros(table), zeros(table)))


def sparse_adam_apply(table: jax.Array, state: SparseOptState,
                      ids: jax.Array, demb: jax.Array,
                      config: TableConfig, lr, step,
                      b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8,
                      ctx: Optional[Context] = None
                      ) -> Tuple[jax.Array, SparseOptState]:
  """LazyAdam on touched rows only (TF ``LazyAdam`` semantics: untouched
  rows' moments do not decay). ``state.acc = (m, v)``; ``step`` is the
  1-based step count for bias correction (may be traced).

  Reference parity: the reference wraps arbitrary TF optimizers whose
  sparse ``apply`` touches only IndexedSlices rows
  (``optimizer.py:55-185`` + ``gradient.py:197-207``); Adagrad/SGD/Adam
  cover its tutorial configurations.
  """
  ctx = ctx or Context.get()
  if config.pack_of(table) > 1:
    raise ValueError(
        f'table {config.name!r}: lane packing is incompatible with '
        'LazyAdam (per-row presence would decay neighboring logical '
        "rows' moments) — declare the table with lane_pack=False or "
        "scope emb_lane_pack='off' for it.")
  rows_b = _valid_rows(config.row_index(ids.reshape(-1), ctx),
                       ids.reshape(-1), config)
  demb = demb.reshape(-1, demb.shape[-1]).astype(table.dtype)
  rows_b, demb = _pad_to_world(rows_b, demb, ctx.world_size)
  m, v = state.acc

  if not config.should_shard(ctx):
    if ctx.world_size > 1:
      def gather(r, g):
        return (jax.lax.all_gather(r, ctx.data_axes, tiled=True),
                jax.lax.all_gather(g, ctx.data_axes, tiled=True))
      rows_b, demb = jax.shard_map(
          gather, mesh=ctx.mesh,
          in_specs=(P(ctx.data_axes), P(ctx.data_axes, None)),
          out_specs=(P(), P()), check_vma=False)(rows_b, demb)
    rows, gsum = _dedup_grads(rows_b, demb, oob_row=table.shape[0])
    table, m, v = _adam_rows(table, m, v, rows, gsum, lr, step,
                             b1, b2, eps)
    return table, SparseOptState(acc=(m, v))

  axes = ctx.data_axes
  if config.partition == 'column':
    vocab_c = config.padded_vocab(ctx)

    def body_c(shard, m_s, v_s, ids_local, demb_local):
      all_ids = jax.lax.all_gather(ids_local, axes, tiled=True)
      slice_g = jax.lax.all_to_all(demb_local, axes, split_axis=1,
                                   concat_axis=0, tiled=True)
      rows, gsum = _dedup_grads(all_ids, slice_g, oob_row=vocab_c)
      return _adam_rows(shard, m_s, v_s, rows, gsum, lr, step,
                        b1, b2, eps)

    fn = jax.shard_map(
        body_c, mesh=ctx.mesh,
        in_specs=(P(None, axes), P(None, axes), P(None, axes),
                  P(axes), P(axes, None)),
        out_specs=(P(None, axes),) * 3, check_vma=False)
    table, m, v = fn(table, m, v, rows_b, demb)
    return table, SparseOptState(acc=(m, v))

  rows_per_shard = config.padded_vocab(ctx) // ctx.world_size

  def apply_local(shard, slot_shards, local, g):
    m_s, v_s = slot_shards
    safe = jnp.where(local >= 0, local, rows_per_shard)
    rows, gsum = _dedup_grads(safe, g, oob_row=rows_per_shard)
    t, m2, v2 = _adam_rows(shard, m_s, v_s, rows, gsum, lr, step,
                           b1, b2, eps)
    return t, (m2, v2)

  table, (m, v) = _rowsharded_update(table, (m, v), rows_b, demb,
                                     apply_local, ctx=ctx)
  return table, SparseOptState(acc=(m, v))
