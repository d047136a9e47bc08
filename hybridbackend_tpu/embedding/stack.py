"""Table stacking: one exchange for many embedding tables.

A JAX re-design of the reference's collective *packing* passes
(``/root/reference/hybridbackend/tensorflow/graph/optimize_collective.cc:94-163``
Pack → ``*N``/``MergedN`` grouped ops, and the PICASSO paper's packing of
sparse lookups): instead of post-hoc graph surgery that merges N NCCL
calls, tables with equal embedding dim are **stacked row-wise into one
physical table** at construction. All their lookups become a single
id-space gather — one all_gather + one reduce_scatter per step for the
whole group, regardless of how many features it serves.

Row layout: table ``i``'s rows live at ``offset[i] + local_id``. The
stacked table is row-sharded like any other; per-feature ids are shifted
by their offset and concatenated into one flat lookup.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from hybridbackend_tpu.embedding.lookup import lookup
from hybridbackend_tpu.embedding.table import (
    TableConfig, create_table, default_initializer)
from hybridbackend_tpu.framework.context import Context


@dataclasses.dataclass(frozen=True)
class TableStack:
  """A group of same-dim tables fused into one physical table."""
  configs: Tuple[TableConfig, ...]
  offsets: Tuple[int, ...]        # row offset of each member table
  stacked: TableConfig            # the physical (stacked) table config

  @property
  def dim(self) -> int:
    return self.stacked.dim

  def member(self, name: str) -> Tuple[TableConfig, int]:
    for cfg, off in zip(self.configs, self.offsets):
      if cfg.name == name:
        return cfg, off
    raise KeyError(name)


def build_stacks(configs: Sequence[TableConfig],
                 ctx: Optional[Context] = None) -> List[TableStack]:
  """Group configs by (dim, dtype, shardability[, strategy]) into stacks.

  Tables that would be replicated (small) are stacked separately from
  sharded ones so the shard policy stays per-group; sharded groups also
  split by their resolved per-table lookup strategy (members share one
  exchange).

  CHECKPOINT CAVEAT: the grouping determines the physical table names
  and member row offsets, so stacks must be built under the SAME option
  scopes (emb_sharded / emb_lookup_strategy / world size policy) when
  saving and when restoring — a different grouping renames the
  checkpoint's table keys. (Restores across different world SIZES are
  fine: arrays are global-shape.)
  """
  ctx = ctx or Context.get()
  from hybridbackend_tpu.framework.options import OPTIONS
  groups: Dict[Tuple, List[TableConfig]] = {}
  for cfg in configs:
    if cfg.shuffle_ids:
      key = ('solo', cfg.name)  # id-mixed tables keep their own space
    else:
      # Per-table scoped lookup strategies (DictOption '*' wildcard)
      # partition the stacks: members of one stack share one exchange,
      # so they must share a strategy — but only SHARDED tables
      # exchange at all; unsharded groups must not fragment over a
      # strategy that is a no-op for them.
      sharded = cfg.should_shard(ctx)
      strat = (OPTIONS.get_for('emb_lookup_strategy', cfg.name)
               if sharded else None)
      # lane_pack is a PHYSICAL-layout property of the stacked array,
      # so members with different explicit settings must not merge
      # (and an explicit setting must survive into the stacked config).
      key = (cfg.dim, str(cfg.dtype), sharded, cfg.partition, strat,
             cfg.lane_pack)
    groups.setdefault(key, []).append(cfg)
  stacks = []
  for key, members in groups.items():
    offsets = []
    total = 0
    world = ctx.world_size if members[0].should_shard(ctx) else 1
    for cfg in members:
      # Each member occupies a world-aligned row range so member rows
      # distribute over shards exactly like a standalone table.
      aligned = ((cfg.vocab_size + world - 1) // world) * world
      offsets.append(total)
      total += aligned
    stacked_cfg = TableConfig(
        name='stack/' + '/'.join(c.name for c in members),
        vocab_size=total, dim=members[0].dim, dtype=members[0].dtype,
        sharded=bool(members[0].should_shard(ctx)),
        combiner=members[0].combiner,
        partition=members[0].partition,
        lane_pack=members[0].lane_pack,
        # Solo stacks keep the member's hot-id spreading (the mix is
        # what keeps skewed vocabularies' exchange buckets uniform);
        # multi-member stacks never mix (offset layout must hold).
        shuffle_ids=(len(members) == 1 and members[0].shuffle_ids))
    stacks.append(TableStack(tuple(members), tuple(offsets), stacked_cfg))
  return stacks


def create_stacked_tables(stacks: Sequence[TableStack], rng: jax.Array,
                          ctx: Optional[Context] = None
                          ) -> Dict[str, jax.Array]:
  """Materialize one physical array per stack, each member initialized
  with its own initializer over its row range."""
  ctx = ctx or Context.get()
  out = {}
  for stack in stacks:
    rng, sub = jax.random.split(rng)
    vocab = stack.stacked.padded_vocab(ctx)

    def init(key, shape, _stack=stack, _vocab=vocab):
      parts = []
      keys = jax.random.split(key, len(_stack.configs))
      bounds = list(_stack.offsets[1:]) + [_vocab]
      for i, cfg in enumerate(_stack.configs):
        init_fn = cfg.initializer or default_initializer
        rows = bounds[i] - _stack.offsets[i]
        parts.append(init_fn(keys[i], (rows, cfg.dim)).astype(cfg.dtype))
      return jnp.concatenate(parts, axis=0)

    cfg2 = dataclasses.replace(stack.stacked, initializer=init)
    out[stack.stacked.name] = create_table(cfg2, sub, ctx)
  return out


def member_tables(stack: TableStack, stacked: jax.Array,
                  ctx: Optional[Context] = None) -> Dict[str, 'jax.Array']:
  """Split a trained stacked physical table back into per-member tables
  (host arrays): ``{member_name: [member_rows, D]}``.

  Inverse of the stacking layout (member ids are offset-shifted, not
  re-mixed, so member row ``i`` lives at stacked row ``offset + i``).
  Used by serving export to reconstruct standalone tables from the
  checkpointed stacked arrays (reference ``export_all`` rebuilds the
  serving graph from checkpoint, ``saved_model.py:54-192``).

  In a multi-process job a row-sharded stack spans non-addressable
  devices, so materializing it is a COLLECTIVE: every process must
  call this function (the trainer's ``export_saved_model`` does)."""
  import numpy as np
  ctx = ctx or Context.get()
  vocab = stack.stacked.padded_vocab(ctx)
  if isinstance(stacked, jax.Array) and not stacked.is_fully_addressable:
    from jax.experimental import multihost_utils
    host = np.asarray(multihost_utils.process_allgather(stacked,
                                                        tiled=True))
  else:
    host = np.asarray(stacked)
  if stack.stacked.pack_of(stacked) > 1:
    # Lane-packed physical layout: free row-major unpack on the host.
    host = host.reshape(-1, stack.stacked.dim)
    vocab = host.shape[0]
  if stack.stacked.shuffle_ids:
    # Solo shuffled stack: logical row r lives at mix(r) — invert by
    # gathering the mixed positions back into logical order.
    cfg = stack.configs[0]
    import jax.numpy as jnp
    rows = np.asarray(stack.stacked.row_index(
        jnp.arange(cfg.vocab_size), ctx))
    return {cfg.name: host[rows]}
  bounds = list(stack.offsets[1:]) + [vocab]
  out = {}
  for i, cfg in enumerate(stack.configs):
    out[cfg.name] = host[stack.offsets[i]:bounds[i]]
  return out


def stacked_lookup(stack: TableStack, table: jax.Array,
                   ids_by_name: Dict[str, jax.Array],
                   ctx: Optional[Context] = None,
                   strategy: Optional[str] = None
                   ) -> Dict[str, jax.Array]:
  """Look up every member's ids with ONE exchange.

  Args:
    ids_by_name: ``{member_name: ids [...]}`` — any shapes; flattened,
      offset-shifted, concatenated, exchanged once, then split back.

  Returns:
    ``{member_name: embeddings ids.shape + (dim,)}``.
  """
  all_ids, layout = pack_ids(stack, ids_by_name)
  emb = lookup(table, all_ids, stack.stacked, ctx=ctx,
               strategy=strategy)                         # [B, K, D]
  return unpack_embeddings(stack, emb, layout)


def pack_ids(stack: TableStack, ids_by_name: Dict[str, jax.Array]
             ) -> Tuple[jax.Array, List[Tuple[str, Tuple[int, ...], int]]]:
  """Offset-shift and concatenate member ids into the stacked id space.

  Batch-major ``[B, K]`` layout: concatenating on axis 1 keeps the batch
  axis (and its sharding) intact, so the fused lookup adds ZERO
  resharding collectives on top of its one all_gather+reduce_scatter.
  Returns ``(all_ids [B, K], layout [(name, orig_shape, width), ...])``.
  """
  names, cols, shapes, widths = [], [], [], []
  batch_dims = set()
  for cfg, off in zip(stack.configs, stack.offsets):
    if cfg.name not in ids_by_name:
      continue
    ids = ids_by_name[cfg.name]
    names.append(cfg.name)
    shapes.append(ids.shape)
    batch_dims.add(ids.shape[0])
    col = ids.reshape(ids.shape[0], -1)
    # Out-of-range member ids must stay out-of-range in the stacked
    # space (not collide with the next member's rows).
    valid = (col >= 0) & (col < cfg.vocab_size)
    cols.append(jnp.where(valid, col + off, jnp.int32(-1)))
    widths.append(col.shape[1])
  if len(batch_dims) != 1:
    raise ValueError(
        f'stacked_lookup needs a common leading batch dim; got {shapes}')
  all_ids = jnp.concatenate(cols, axis=1)                # [B, K]
  return all_ids, list(zip(names, shapes, widths))


def unpack_embeddings(stack: TableStack, emb: jax.Array,
                      layout) -> Dict[str, jax.Array]:
  """Split fused ``[B, K, D]`` embeddings back per member.

  The leading (batch) dim follows ``emb`` itself, not the layout's
  recorded shape: inside a ``shard_map`` body (the wire-compressed
  gradient path) ``emb`` carries the per-device batch slice while the
  layout was built from the global trace.
  """
  out = {}
  pos = 0
  for name, shape, width in layout:
    out[name] = emb[:, pos:pos + width].reshape(
        emb.shape[0], *shape[1:], stack.dim)
    pos += width
  return out


__all__ = ['TableStack', 'build_stacks', 'create_stacked_tables',
           'stacked_lookup', 'pack_ids', 'unpack_embeddings']
