"""Static-shape ID partitioning for sharded-embedding exchange.

A JAX re-design of the reference partition kernels
(``/root/reference/hybridbackend/tensorflow/distribute/partition/``):
``HbPartitionByModulo[N]`` (``partition_by_modulo_ops.cc:46-155``) buckets
IDs by ``id % num_shards`` and returns shuffled ids + per-shard sizes +
restore indices; the dual-modulo variant
(``partition_by_dual_modulo_ops.cc:46-278``) stages the split for
hierarchical (intra-node, then inter-node) exchange.

XLA needs static shapes, so buckets have a fixed ``capacity`` and a
validity ``sizes`` vector — the bucketed layout feeds directly into
:func:`hybridbackend_tpu.distribute.collective.all_to_all_v_t`. The
implementation is a stable sort by shard plus a scatter, which lowers to
an efficient bitonic sort on the VPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


class Partitioned(NamedTuple):
  """Result of a bucketed partition.

  Attributes:
    buckets: ``[num_shards, capacity]`` bucketed ids, padded with
      ``fill_value``.
    sizes: ``[num_shards]`` int32 valid counts per bucket.
    restore: ``[n]`` int32; ``buckets.reshape(-1)[restore] == ids``, i.e.
      flat bucket position of each original element (the reference's
      "restore index", ``partition_by_modulo_ops.cc:46-155``). A payload
      that round-trips through the buckets is unbucketed with
      ``flat_payload[restore]``. Elements discarded via the ``valid``
      mask (and bucket-overflow lanes) carry an out-of-range position —
      unbucket with ``mode='clip'`` and mask the result.
    overflow: scalar bool — True when any bucket received more valid
      elements than ``capacity`` (those lanes were dropped). Callers
      needing losslessness should fall back to a full-capacity exchange
      when set (cf. ``emb_lookup_overflow_fallback``).
  """
  buckets: jax.Array
  sizes: jax.Array
  restore: jax.Array
  overflow: jax.Array = None


def partition_by_modulo(ids: jax.Array, num_shards: int,
                        capacity: Optional[int] = None,
                        fill_value: int = 0) -> Partitioned:
  """Bucket ``ids`` by ``id % num_shards`` with static shapes.

  Args:
    ids: ``[n]`` integer ids.
    num_shards: number of buckets (the world size of the exchange).
    capacity: rows per bucket; defaults to ``n`` (always lossless). A
      smaller capacity drops overflow — only safe when the caller proves a
      bound on per-shard counts.
  """
  return partition_by_fn(ids, num_shards, lambda x: x % num_shards,
                         capacity=capacity, fill_value=fill_value)


def partition_by_fn(ids: jax.Array, num_shards: int, shard_fn,
                    capacity: Optional[int] = None,
                    fill_value: int = 0,
                    valid: Optional[jax.Array] = None) -> Partitioned:
  """Bucket ``ids`` by an arbitrary shard assignment function.

  ``valid`` (optional ``[n]`` bool) marks elements to discard: they
  consume no bucket capacity and their ``restore`` position is
  out-of-range (unbucket payloads with ``mode='clip'`` and mask). This
  is how padding/-1 lanes stay out of tight-capacity exchanges
  (reference: invalid ids never enter the alltoallv,
  ``partition_by_modulo_ops.cc:46-155``).
  """
  n = ids.shape[0]
  if capacity is None:
    capacity = n
  shard = shard_fn(ids).astype(jnp.int32)
  if valid is not None:
    # Discarded elements route to a virtual bucket ``num_shards`` that
    # is never materialized.
    shard = jnp.where(valid, shard, jnp.int32(num_shards))
  # Stable sort by shard keeps intra-bucket order = original order.
  order = jnp.argsort(shard, stable=True)
  sorted_shard = shard[order]
  sorted_ids = ids[order]
  counts = jnp.bincount(shard, length=num_shards + 1).astype(jnp.int32)
  sizes = counts[:num_shards]
  starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts)[:-1].astype(jnp.int32)])
  pos_in_bucket = (
      jnp.arange(n, dtype=jnp.int32) - starts[sorted_shard])
  in_cap = (pos_in_bucket < capacity) & (sorted_shard < num_shards)
  flat_pos = jnp.where(in_cap, sorted_shard * capacity + pos_in_bucket,
                       num_shards * capacity)
  buckets = jnp.full((num_shards * capacity,), fill_value, ids.dtype)
  buckets = buckets.at[flat_pos].set(
      jnp.where(in_cap, sorted_ids, buckets[0]), mode='drop')
  # restore[original_index] = flat bucket position
  restore = jnp.zeros((n,), jnp.int32).at[order].set(flat_pos)
  overflow = jnp.any(sizes > capacity)
  if capacity < n:
    sizes = jnp.minimum(sizes, capacity)
  return Partitioned(buckets.reshape(num_shards, capacity), sizes, restore,
                     overflow)


def partition_by_dual_modulo(
    ids: jax.Array, num_stage0: int, num_stage1: int,
    capacity: Optional[int] = None,
    fill_value: int = 0) -> Tuple[Partitioned, jax.Array]:
  """Two-stage (hierarchical) partition.

  Stage 0 buckets by ``(id // num_stage1) % num_stage0`` (which *node
  group* owns the id), and also returns the stage-1 key
  ``id % num_stage1`` for the subsequent intra-group exchange — mirroring
  ``HbPartitionByDualModuloStageOne/Two``
  (``partition_by_dual_modulo_ops.cc:46-278``).

  Returns:
    (stage-0 :class:`Partitioned` of the ids, per-element stage-1 keys
    in the same bucketed layout ``[num_stage0, capacity]``).
  """
  part = partition_by_fn(
      ids, num_stage0, lambda x: (x // num_stage1) % num_stage0,
      capacity=capacity, fill_value=fill_value)
  stage1_keys = part.buckets % num_stage1
  return part, stage1_keys


def unpartition(flat_payload: jax.Array, restore: jax.Array) -> jax.Array:
  """Undo a partition on a payload that round-tripped through buckets.

  ``flat_payload`` is ``buckets``-layout flattened over the first two dims.
  """
  return flat_payload[restore]


__all__ = ['Partitioned', 'partition_by_modulo', 'partition_by_fn',
           'partition_by_dual_modulo', 'unpartition']
