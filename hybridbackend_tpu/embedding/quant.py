"""int8 quantized embedding tables (serving-time residency format).

Beyond the reference: a served embedding table rarely needs
f32 rows — per-row symmetric int8 keeps prediction drift at the
quantization noise floor while cutting table HBM residency and bundle
size ~4×. The reference serves f32 tables only
(``/root/reference/hybridbackend/tensorflow/training/saved_model.py``);
its GPU-cache layer solves the same capacity problem dynamically
(``embedding/service.py:50-324``) — quantization is the static,
zero-infrastructure alternative for inference.

Residency: narrow int8 tables store LANE-PACKED — ``[V, d]`` as
``[V/p, p·d = 128]`` (the format ``emb_lane_pack='on'`` gives f32
training tables, ``TableConfig.pack_factor``). The gather fetches
128-wide rows, and the dequantize + lane-select fuse into ONE wide
einsum: the per-row scale rides the lane one-hot
(``out[n] = Σ_k (1[k = lane(n)]·scale(n)) · qrow[n, k·d:]``), so
nothing but the final [N, d] output is narrow.

Format: ``QuantizedTable(q: int8, scale: f32 [V], pack, dim)`` with
``row v = q-slice(v) · scale[v]`` and ``scale = max|row| / 127``
(symmetric, per-row — embedding row norms vary over orders of
magnitude, so a single per-table scale would crush small rows). A
pytree (``pack``/``dim`` are static leaves), so it flows through
``jax.export``/orbax like any parameter leaf.

Training always stays f32/bf16; quantize at export
(``SparseTrainer.export_saved_model(..., table_dtype='int8')``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class QuantizedTable:
  """Per-row symmetric int8 table: ``row v = q[v] * scale[v]``.

  ``pack > 1``: ``q`` is lane-packed ``[V/pack, pack·dim]`` — logical
  row ``v`` lives in lane slice ``(v % pack)·dim`` of packed row
  ``v // pack``. ``dim`` records the logical row width (0 = legacy
  unpacked, ``q.shape[1]``).
  """
  q: jax.Array       # int8 [V/pack, pack*dim] (or [V, dim] unpacked)
  scale: jax.Array   # f32 [V]
  pack: int = 1
  dim: int = 0

  @property
  def vocab(self) -> int:
    return self.scale.shape[0]

  @property
  def logical_dim(self) -> int:
    return self.dim or self.q.shape[1]


jax.tree_util.register_dataclass(QuantizedTable,
                                 data_fields=('q', 'scale'),
                                 meta_fields=('pack', 'dim'))


def quantize_table(table, pack: bool = True) -> QuantizedTable:
  """Per-row symmetric int8 quantization of a [V, D] float table.

  ``pack`` lane-packs narrow tables (``128 % D == 0``, vocab
  divisible) — the serving residency that keeps the gather on full
  memory tiles."""
  t = np.asarray(table, dtype=np.float32)
  if t.ndim != 2:
    raise ValueError(f'expected a [V, D] table, got shape {t.shape}')
  v, d = t.shape
  amax = np.abs(t).max(axis=1)
  scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
  q = np.clip(np.rint(t / scale[:, None]), -127, 127).astype(np.int8)
  p = 1
  if pack and d < 128 and 128 % d == 0 and v % (128 // d) == 0:
    p = 128 // d
    q = q.reshape(v // p, p * d)   # row-major: consecutive logical rows
  return QuantizedTable(q=q, scale=scale, pack=p, dim=d)


def dequantize_table(qt: QuantizedTable) -> np.ndarray:
  q = np.asarray(qt.q)
  if qt.pack > 1:
    q = q.reshape(qt.vocab, qt.logical_dim)
  return q.astype(np.float32) * np.asarray(qt.scale, np.float32)[:, None]


def shard_quantized(qt: QuantizedTable, ctx=None) -> QuantizedTable:
  """Row-shard a quantized table over the context mesh (serving bundles
  larger than one chip's HBM — the exact case int8's 4× capacity win
  targets). Packed rows pad to a world multiple (padding rows are
  invalid ids and read zeros); ``q`` shards ``P(axes, None)``, ``scale``
  ``P(axes)``."""
  from jax.sharding import PartitionSpec as P
  from hybridbackend_tpu.framework.context import Context
  ctx = ctx or Context.get()
  w = ctx.world_size
  q, scale, p = np.asarray(qt.q), np.asarray(qt.scale), qt.pack
  kv = q.shape[0]
  pad = (-kv) % w
  if pad:
    q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.int8)])
    scale = np.concatenate(
        [scale, np.ones((pad * p,), np.float32)])
  return QuantizedTable(
      q=jax.device_put(q, ctx.sharding(ctx.data_axes, None)),
      scale=jax.device_put(scale, ctx.sharding(ctx.data_axes)),
      pack=p, dim=qt.dim)


def _q_lookup_sharded(qt: QuantizedTable, rows, valid, config, ctx):
  """allgather-strategy sharded int8 lookup: all_gather ids → owned
  fused dequant gather → psum_scatter (mirrors ``_lookup_allgather``,
  ``lookup.py:267-280``, with the quantized local gather)."""
  import jax.numpy as jnp
  from jax.sharding import PartitionSpec as P
  p, d = qt.pack, qt.logical_dim
  w = ctx.world_size
  axes = ctx.data_axes
  kv_per = qt.q.shape[0] // w
  rows_per = kv_per * p
  shape = rows.shape
  flat = jnp.where(valid.reshape(-1), rows.reshape(-1), -1)
  n = flat.shape[0]
  pn = -(-n // w) * w
  if pn != n:
    flat = jnp.concatenate([flat, jnp.full((pn - n,), -1, flat.dtype)])

  def body(q_shard, scale_shard, ids_all):
    from hybridbackend_tpu.distribute.collective import axis_index_t
    me = axis_index_t(axes)
    owner = jnp.where(ids_all >= 0, ids_all // rows_per, -1)
    localr = ids_all - me * rows_per
    mine = owner == me
    lp = jnp.where(mine, localr // p, 0)
    lane = jnp.where(mine, (localr % p).astype(jnp.int32), 0)
    qrows = jnp.take(q_shard, lp, axis=0, mode='clip')
    q3 = qrows.reshape(pn, p, d).astype(jnp.float32)
    sc = jnp.take(scale_shard, jnp.clip(localr, 0, rows_per - 1), axis=0)
    sc = jnp.where(mine, sc, 0.0)
    ohs = (lane[:, None] == jnp.arange(p, dtype=jnp.int32)[None, :]
           ).astype(jnp.float32) * sc[:, None]
    contrib = jnp.einsum('np,npd->nd', ohs, q3)
    return jax.lax.psum_scatter(contrib, axes, scatter_dimension=0,
                                tiled=True)

  out = jax.shard_map(
      body, mesh=ctx.mesh,
      in_specs=(P(axes, None), P(axes), P()),
      out_specs=P(axes, None), check_vma=False)(qt.q, qt.scale, flat)
  return out[:n].reshape(*shape, d)


def lookup_quantized(qt: QuantizedTable, ids: jax.Array, config,
                     ctx=None) -> jax.Array:
  """Quantized-table lookup with on-the-fly dequantization.

  Serving-time path: gathers int8 rows (lane-packed when the table is)
  and fuses dequantize + lane-select into one wide einsum — the
  per-row scale is folded into the lane one-hot so no narrow
  intermediate exists. Sharded configs route through the allgather
  exchange with the quantized local gather (``shard_quantized`` first),
  so bundles larger than one chip's HBM serve sharded. The same
  validity contract as every float path: out-of-vocab/negative ids
  read zeros.
  """
  if config.should_shard(ctx):
    from hybridbackend_tpu.framework.context import Context
    ctx = ctx or Context.get()
    if qt.pack <= 1:
      raise NotImplementedError(
          'sharded int8 serving requires the lane-packed residency '
          '(quantize_table(pack=True), then shard_quantized)')
    rows = config.row_index(ids, ctx)
    valid = (ids >= 0) & (ids < config.vocab_size)
    return _q_lookup_sharded(qt, rows, valid, config, ctx)
  rows = config.row_index(ids, ctx)
  valid = (ids >= 0) & (ids < config.vocab_size)
  rows = jnp.where(valid, rows, -1)
  p, d, v = qt.pack, qt.logical_dim, qt.vocab
  if p <= 1:
    qe = jnp.take(qt.q, rows, axis=0, mode='fill', fill_value=0)
    sc = jnp.take(qt.scale, jnp.clip(rows, 0, v - 1), axis=0)
    sc = jnp.where(valid, sc, 0.0)
    return qe.astype(jnp.float32) * sc[..., None]
  shape = rows.shape
  flat = rows.reshape(-1)
  fvalid = valid.reshape(-1)
  prow = jnp.where(flat >= 0, flat // p, -1)
  lane = jnp.where(flat >= 0, (flat % p).astype(jnp.int32), 0)
  qrows = jnp.take(qt.q, prow, axis=0, mode='fill', fill_value=0)
  n = flat.shape[0]
  # Wide f32 cast on the 2-D [n, 128] form, then a broadcast-multiply-
  # reduce select with the per-row scale folded into the lane one-hot.
  # Its speed on the GPU against an unpacked int8 gather is not
  # measured.
  wide = qrows.astype(jnp.float32)
  sc = jnp.take(qt.scale, jnp.clip(flat, 0, v - 1), axis=0)
  sc = jnp.where(fvalid, sc, 0.0)
  ohs = (lane[:, None] == jnp.arange(p, dtype=jnp.int32)[None, :]
         ).astype(jnp.float32) * sc[:, None]           # [n, p]
  out = (wide.reshape(n, p, d) * ohs[..., None]).sum(-2)
  return out.reshape(*shape, d)


__all__ = ['QuantizedTable', 'quantize_table', 'dequantize_table',
           'lookup_quantized', 'shard_quantized']
