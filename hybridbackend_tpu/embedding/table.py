"""Sharded embedding table creation and shard policy.

A JAX re-design of the reference's sharded embedding weights
(``/root/reference/hybridbackend/tensorflow/embedding/sharding.py:49-139``
and ``embedding/variables.py:69-162``). The reference patches
``tf.get_variable`` to build per-rank ``name/part_<rank>`` variables with
``SaveSliceInfo``; in JAX a table is ONE logical global array of shape
``[vocab, dim]`` carrying a :class:`jax.sharding.NamedSharding` that
row-shards it across the mesh. World-size-independent checkpointing
(reference ``SaveSliceInfo``, ``variables.py:126-141``) falls out of
global-shape semantics for free.

Shard policy parity (``variables.py:69-146``):

* tables with ``vocab < world_size`` or ``vocab <= min_shard_rows`` are
  replicated (reference ``TRAINABLE_REPLICATED_SMALL``);
* otherwise row-sharded. The reference shards by ``id % world_size``;
  we shard in contiguous blocks (``owner = id // rows_per_shard``), which
  is what XLA's block-partitioned layout wants and keeps checkpoints in
  logical row order. Skew-prone workloads can enable ``shuffle_ids`` to
  spread hot (low) ids across shards via an invertible multiplicative
  mix — the analogue of the reference's modulo interleaving.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from hybridbackend_tpu.framework.context import Context
from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('emb_sharded', True, env='HB_EMB_SHARDED',
                 doc='Globally enable/disable embedding sharding '
                     '(reference option `sharding`).')
OPTIONS.register('emb_min_shard_rows', 0, env='HB_EMB_MIN_SHARD_ROWS',
                 doc='Tables with fewer rows than this stay replicated.')
OPTIONS.register('emb_lookup_strategy', 'allgather',
                 env='HB_EMB_LOOKUP_STRATEGY',
                 doc='Sharded lookup algorithm: allgather|alltoall|gspmd.')
OPTIONS.register('emb_unique_ratio', 1.0, env='HB_EMB_UNIQUE_RATIO',
                 doc='Capacity of the static dedup as a fraction of batch '
                     '(1.0 = exact, lossless).')
OPTIONS.register(
    'emb_lookup_bucket_ratio', 2.0, env='HB_EMB_LOOKUP_BUCKET_RATIO',
    doc='Forward alltoall/hierarchical lookup bucket capacity as a '
        'multiple of the uniform per-peer share (ceil(ratio*b/W) rows '
        'per bucket). With ratio r the id payload shrinks from [W*b] to '
        '[r*b] and the embedding payload from [W*b, D] to [r*b, D] — '
        'the wire-proportional win of the reference alltoallv '
        '(nccl_alltoallv.cc:200-350). Modulo row sharding spreads ids '
        'near-uniformly, so 2.0 has large headroom; overflow never '
        'corrupts — see emb_lookup_overflow_fallback. <= 0 disables '
        'bucketing (full-capacity exchange).')
OPTIONS.register(
    'emb_lookup_overflow_fallback', True,
    env='HB_EMB_LOOKUP_OVERFLOW_FALLBACK',
    doc='When a forward lookup bucket overflows, re-route that step '
        'through the full-capacity exchange (globally-uniform lax.cond '
        'branch, exact). Disabling leaves garbage embeddings in '
        'overflowed lanes — only for benchmarking.')
OPTIONS.register(
    'emb_lane_pack', 'off', env='HB_EMB_LANE_PACK',
    doc="Store narrow (dim<128, 128%dim==0) row-partition tables "
        "lane-PACKED as [V/p, 128] physical arrays (p=128/dim): 'on' "
        "packs; 'off' keeps [V, dim] ('auto' is a deprecated alias of "
        "'off'). Packing makes the "
        "lookup gather 128-wide rows and select lanes, and widens "
        "every update p-fold; on the GPU the unpacked flagship step is "
        "the faster one (PERF.md). LazyAdam tables never pack (per-row "
        "presence needs a spare lane).")


def _round_up(x: int, m: int) -> int:
  return ((x + m - 1) // m) * m


def _mix_constant(n_pow2: int) -> int:
  """Odd multiplier for an invertible multiplicative mix mod 2^k."""
  # Knuth's multiplicative-hash constant, forced odd → bijective mod 2^k.
  return 0x9E3779B1 | 1


@dataclasses.dataclass(frozen=True)
class TableConfig:
  """Declarative embedding table spec.

  Mirrors what the reference derives from ``get_variable`` call sites plus
  the combiner in ``embedding_lookup_sparse``.
  """
  name: str
  vocab_size: int
  dim: int
  initializer: Optional[Callable[[jax.Array, Tuple[int, int]], jax.Array]] = None
  combiner: str = 'sum'            # for sparse (ragged) lookups
  dtype: jnp.dtype = jnp.float32
  sharded: Optional[bool] = None   # None = auto policy
  shuffle_ids: bool = False        # spread hot ids across block shards
  partition: str = 'row'           # 'row' | 'column' (dim-axis sharding
                                   # for large-dim tables; requires
                                   # dim % world_size == 0)
  lane_pack: Optional[bool] = None  # None = emb_lane_pack option policy

  def should_shard(self, ctx: Optional[Context] = None) -> bool:
    """Reference policy: shard iff world>1 ∧ sharding enabled ∧ table is
    big enough (``sharding.py:67-75``, ``variables.py:69-146``)."""
    ctx = ctx or Context.get()
    if self.sharded is not None:
      return self.sharded and ctx.world_size > 1
    if ctx.world_size <= 1 or not OPTIONS.get_for('emb_sharded',
                                                  self.name):
      return False
    if self.vocab_size < ctx.world_size:
      return False
    if self.vocab_size < int(OPTIONS.get_for('emb_min_shard_rows',
                                             self.name)):
      return False
    return True

  def pack_factor(self, ctx: Optional[Context] = None) -> int:
    """Lane-packing factor ``p`` (1 = unpacked): the table is stored
    physically as ``[padded_vocab/p, p·dim = 128]`` (see the
    ``emb_lane_pack`` option doc)."""
    if self.dim >= 128 or 128 % self.dim != 0 or self.partition != 'row':
      return 1
    want = self.lane_pack
    if want is None:
      want = str(OPTIONS.get_for('emb_lane_pack', self.name)) == 'on'
    return 128 // self.dim if want else 1

  def pack_of(self, table) -> int:
    """PHYSICAL lane-pack factor of a concrete table array.

    Derived from the array's minor dim, NOT from ctx: the layout is
    fixed at creation time, and a later context with a different world
    size (e.g. a single-chip serving trace of weights trained unpacked
    on an 8-device mesh) must follow the array, not re-decide
    ``pack_factor``'s auto policy."""
    w = int(table.shape[-1])
    if w == self.dim:
      return 1
    if self.dim < 128 and 128 % self.dim == 0 and w == 128:
      return 128 // self.dim
    raise ValueError(
        f'table {self.name!r}: physical width {w} matches neither '
        f'dim={self.dim} nor its 128-lane packing')

  def padded_vocab(self, ctx: Optional[Context] = None) -> int:
    """Vocab rounded up so every shard holds the same number of rows
    (and, when lane-packed, so packed rows split evenly too)."""
    ctx = ctx or Context.get()
    world = ctx.world_size if (self.should_shard(ctx)
                               and self.partition == 'row') else 1
    v = self.vocab_size
    if self.shuffle_ids:
      v = 1 << (v - 1).bit_length()  # pow2 for the invertible mix
    return _round_up(v, world * self.pack_factor(ctx))

  def packed_shape(self, ctx: Optional[Context] = None) -> Tuple[int, int]:
    """PHYSICAL array shape: [padded_vocab/p, p·dim]."""
    ctx = ctx or Context.get()
    p = self.pack_factor(ctx)
    return self.padded_vocab(ctx) // p, p * self.dim

  def row_index(self, ids: jax.Array, ctx: Optional[Context] = None):
    """Map feature ids to physical table rows (identity unless shuffled).

    Invalid ids (``< 0``, e.g. batch-padding lanes) stay invalid: the
    uint32 mix would otherwise map ``-1`` to an arbitrary *valid* row,
    breaking the no-owner-shard → zero-embedding contract downstream."""
    if not self.shuffle_ids:
      return ids
    n = self.padded_vocab(ctx)
    c = _mix_constant(n)
    mixed = (ids.astype(jnp.uint32) * jnp.uint32(c)
             % jnp.uint32(n)).astype(ids.dtype)
    return jnp.where(ids >= 0, mixed, ids)

  def resolve(self, ctx: Optional[Context] = None) -> 'TableConfig':
    """Bake the CURRENT shard policy into an explicit config.

    ``should_shard`` consults scoped options at every call; a table
    created inside ``hb.embedding_scope(...)`` but looked up outside it
    would otherwise flip policy. Resolve the config at creation time
    when the scopes differ."""
    if self.sharded is not None:
      return self
    return dataclasses.replace(self, sharded=bool(self.should_shard(ctx)))

  def sharding(self, ctx: Optional[Context] = None) -> NamedSharding:
    ctx = ctx or Context.get()
    if self.should_shard(ctx):
      if self.partition == 'column':
        if self.dim % ctx.world_size != 0:
          raise ValueError(
              f'Column-sharded table {self.name!r}: dim={self.dim} must '
              f'divide evenly by world_size={ctx.world_size} (pad dim '
              f'or use partition="row")')
        return NamedSharding(ctx.mesh, P(None, ctx.data_axes))
      return NamedSharding(ctx.mesh, P(ctx.data_axes, None))
    return NamedSharding(ctx.mesh, P(None, None))


def default_initializer(rng: jax.Array, shape: Tuple[int, int],
                        dtype=jnp.float32) -> jax.Array:
  """Reference models use truncated-normal-ish init scaled by 1/sqrt(dim)."""
  scale = 1.0 / np.sqrt(shape[1])
  return jax.random.uniform(rng, shape, dtype, -scale, scale)


def create_table(config: TableConfig, rng: jax.Array,
                 ctx: Optional[Context] = None) -> jax.Array:
  """Materialize a table as a (possibly row-sharded) global array.

  Lane-packed tables (``config.pack_factor() > 1``) come back with the
  PHYSICAL shape ``[padded_vocab/p, p·dim]`` — logical row ``r`` lives
  at packed row ``r//p``, lane slice ``(r%p)·dim``; ``lookup`` and the
  sparse update paths handle the mapping transparently."""
  ctx = ctx or Context.get()
  vocab = config.padded_vocab(ctx)
  init = config.initializer or default_initializer
  sharding = config.sharding(ctx)
  p = config.pack_factor(ctx)

  @jax.jit
  def _init(rng):
    out = init(rng, (vocab, config.dim)).astype(config.dtype)
    if p > 1:
      # Row-major reshape: logical rows interleave into lane slices.
      out = out.reshape(vocab // p, p * config.dim)
    return jax.lax.with_sharding_constraint(out, sharding)

  with ctx.mesh:
    return jax.jit(_init, out_shardings=sharding)(rng)


__all__ = ['TableConfig', 'create_table', 'default_initializer']
