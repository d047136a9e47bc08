"""Feature extraction: batch columns → embedding/dense feature vectors.

The JAX analogue of the reference tutorial's ``extract_features``
(``/root/reference/docs/tutorial/ranking/taobao/train.py:36-160``), which
wraps each categorical column in ``hb.embedding_scope`` so its table is
sharded. Here the same declaration is explicit: an
:class:`EmbeddingSpec` per categorical column (dense columns pass
through), table params created under the context mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from hybridbackend_tpu.embedding.lookup import lookup, lookup_sparse
from hybridbackend_tpu.embedding.table import TableConfig, create_table
from hybridbackend_tpu.framework.context import Context


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
  """One categorical feature backed by an embedding table.

  ``column`` is the batch key holding ids; ragged (multi-valent) columns
  use ``column`` for the padded ids and ``column + '_mask'`` for
  validity, combined by ``config.combiner``.
  """
  config: TableConfig
  column: Optional[str] = None

  @property
  def name(self) -> str:
    return self.config.name

  @property
  def key(self) -> str:
    return self.column or self.config.name


def init_tables(specs: Sequence[EmbeddingSpec], rng: jax.Array,
                ctx: Optional[Context] = None) -> Dict[str, jax.Array]:
  """Create all embedding tables as a params subtree keyed by name."""
  tables = {}
  for spec in specs:
    rng, sub = jax.random.split(rng)
    tables[spec.name] = create_table(spec.config, sub, ctx)
  return tables


def extract_features(tables: Dict[str, jax.Array],
                     batch: Dict[str, jax.Array],
                     specs: Sequence[EmbeddingSpec],
                     dense_columns: Sequence[str] = (),
                     ctx: Optional[Context] = None
                     ) -> Tuple[List[jax.Array], List[jax.Array]]:
  """Returns (embedding feature list [B, dim] each, dense feature list).

  Ragged columns (padded + mask present in batch) are combined via
  ``lookup_sparse``; scalar id columns via ``lookup``.
  """
  emb_features = []
  for spec in specs:
    ids = batch[spec.key]
    table = tables[spec.name]
    mask_key = spec.key + '_mask'
    if ids.ndim >= 2 and mask_key in batch:
      emb = lookup_sparse(table, ids, batch[mask_key], spec.config, ctx=ctx)
    else:
      emb = lookup(table, ids, spec.config, ctx=ctx)
      if emb.ndim > 2:  # fixed-width multivalent: combine by config
        emb = jnp.mean(emb, axis=-2)
    emb_features.append(emb)
  dense_features = []
  for col in dense_columns:
    v = batch[col]
    if v.ndim == 1:
      v = v[:, None]
    dense_features.append(v.astype(jnp.float32))
  return emb_features, dense_features


class StackedFeatureExtractor:
  """Feature extraction with table stacking: ALL same-dim tables share
  one physical table and one collective exchange per step (PICASSO-style
  packing; see ``embedding/stack.py``). Drop-in upgrade over
  :func:`extract_features` for models with many categorical columns.
  """

  def __init__(self, specs: Sequence[EmbeddingSpec],
               dense_columns: Sequence[str] = (),
               ctx: Optional[Context] = None):
    from hybridbackend_tpu.embedding.stack import build_stacks
    self.specs = list(specs)
    self.dense_columns = list(dense_columns)
    self._ctx = ctx
    self.stacks = build_stacks([s.config for s in specs], ctx)
    self._stack_of = {}
    for stack in self.stacks:
      for cfg in stack.configs:
        self._stack_of[cfg.name] = stack

  def init(self, rng: jax.Array) -> Dict[str, jax.Array]:
    from hybridbackend_tpu.embedding.stack import create_stacked_tables
    return create_stacked_tables(self.stacks, rng, self._ctx)

  def member_ids(self, batch: Dict[str, jax.Array]
                 ) -> Dict[str, Dict[str, jax.Array]]:
    """Per-stack ``{member_name: ids}`` present in the batch."""
    by_spec_name = {s.config.name: s for s in self.specs}
    out = {}
    for stack in self.stacks:
      ids_by_name = {}
      for cfg in stack.configs:
        spec = by_spec_name[cfg.name]
        if spec.key in batch:
          ids_by_name[cfg.name] = batch[spec.key]
      if ids_by_name:
        out[stack.stacked.name] = ids_by_name
    return out

  def lookup_raw(self, tables: Dict[str, jax.Array],
                 batch: Dict[str, jax.Array],
                 strategy: Optional[str] = None):
    """One fused lookup per stack; returns uncombined embeddings plus
    the packed ids (the sparse-update path needs both).

    Returns ``(raw_by_stack {stack: [B,K,D]}, ids_by_stack {stack:
    [B,K]}, layouts {stack: layout})``.
    """
    from hybridbackend_tpu.embedding.lookup import lookup
    from hybridbackend_tpu.embedding.stack import pack_ids
    raw, ids_out, layouts = {}, {}, {}
    member_ids = self.member_ids(batch)
    for stack in self.stacks:
      name = stack.stacked.name
      if name not in member_ids:
        continue
      all_ids, layout = pack_ids(stack, member_ids[name])
      # Resolve per-table scoped strategies against the MEMBER name
      # (members of a stack share one by construction — build_stacks
      # groups by resolved strategy).
      from hybridbackend_tpu.framework.options import OPTIONS
      strat = strategy or OPTIONS.get_for('emb_lookup_strategy',
                                          stack.configs[0].name)
      raw[name] = lookup(tables[name], all_ids, stack.stacked,
                         ctx=self._ctx, strategy=strat)
      ids_out[name] = all_ids
      layouts[name] = layout
    return raw, ids_out, layouts

  def combine_from_raw(self, raw_by_stack, layouts,
                       batch: Dict[str, jax.Array]
                       ) -> Tuple[List[jax.Array], List[jax.Array]]:
    """Differentiable combine: fused raw embeddings → per-spec features
    (applies ragged combiners). Chain-rule through this gives the
    sparse-update path its per-id gradients."""
    from hybridbackend_tpu.embedding.stack import unpack_embeddings
    raw: Dict[str, jax.Array] = {}
    for stack in self.stacks:
      name = stack.stacked.name
      if name in raw_by_stack:
        raw.update(unpack_embeddings(stack, raw_by_stack[name],
                                     layouts[name]))
    by_spec_name = {s.config.name: s for s in self.specs}
    emb_features = []
    for spec in self.specs:
      emb = raw[spec.config.name]
      mask_key = spec.key + '_mask'
      if emb.ndim == 3:
        if mask_key in batch:
          m = batch[mask_key].astype(emb.dtype)
        else:
          m = jnp.ones(emb.shape[:2], emb.dtype)
        combiner = spec.config.combiner
        total = jnp.sum(emb * m[..., None], axis=-2)
        if combiner == 'sum':
          emb = total
        elif combiner == 'mean':
          emb = total / jnp.maximum(
              jnp.sum(m, axis=-1, keepdims=True), 1e-9)
        elif combiner == 'sqrtn':
          emb = total / jnp.sqrt(jnp.maximum(
              jnp.sum(m, axis=-1, keepdims=True), 1e-9))
        else:
          raise ValueError(f'Unknown combiner: {combiner!r}')
      emb_features.append(emb)
    dense_features = []
    for col in self.dense_columns:
      v = batch[col]
      if v.ndim == 1:
        v = v[:, None]
      dense_features.append(v.astype(jnp.float32))
    return emb_features, dense_features

  def __call__(self, tables: Dict[str, jax.Array],
               batch: Dict[str, jax.Array],
               strategy: Optional[str] = None
               ) -> Tuple[List[jax.Array], List[jax.Array]]:
    raw, _, layouts = self.lookup_raw(tables, batch, strategy)
    return self.combine_from_raw(raw, layouts, batch)


__all__ = ['EmbeddingSpec', 'init_tables', 'extract_features',
           'StackedFeatureExtractor']
