"""World-size-independent sharded checkpointing.

A JAX replacement for the reference's sharded Saver protocol
(``/root/reference/hybridbackend/tensorflow/training/saver.py:57-341``):
the reference has every rank write its variable shards to temp files,
rendezvous on a Barrier, and rank0 merge checkpoints; shard metadata
(``SaveSliceInfo``) makes restores world-size independent.

In JAX all of that collapses into Orbax + global-shape arrays: each
embedding table is ONE logical array whose NamedSharding determines
which host writes which rows; Orbax writes shards in parallel per host
and restores under *any* new mesh/world size (reference parity:
``embedding/variables.py:126-141``). Restore of missing variables falls
back to the caller's freshly-initialized values (reference
``saver.py:207-214``).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax

from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('keep_checkpoint_max', 5, env='HB_KEEP_CHECKPOINT_MAX',
                 doc='Maximum number of recent checkpoints to retain.')
OPTIONS.register(
    'ckpt_grow_vocab', False, env='HB_CKPT_GROW_VOCAB',
    doc='Warm-start restore into GROWN embedding tables: a stored '
        '[V1, D] 2-D leaf restores into a [V2 > V1, D] template as the '
        'first V1 rows, keeping the template\'s freshly-initialized '
        'tail (vocabulary expansion between runs). Only valid for '
        'tables with shuffle_ids=False (row mixing re-permutes on '
        'resize). Default off: shape mismatches raise.')


class CheckpointManager:
  """Thin wrapper over orbax CheckpointManager with reference semantics."""

  def __init__(self, directory: str, max_to_keep: Optional[int] = None):
    if max_to_keep is None:
      max_to_keep = int(OPTIONS['keep_checkpoint_max'])
    # Imported here so that the package imports without orbax.
    import orbax.checkpoint as ocp
    self._ocp = ocp
    self._dir = os.path.abspath(directory)
    self._mgr = ocp.CheckpointManager(
        self._dir,
        options=ocp.CheckpointManagerOptions(
            max_to_keep=max_to_keep, create=True, enable_async_checkpointing=False))

  @property
  def directory(self) -> str:
    return self._dir

  def save(self, step: int, state: Any, wait: bool = True) -> None:
    self._mgr.save(step, args=self._ocp.args.StandardSave(state))
    if wait:
      self._mgr.wait_until_finished()

  def latest_step(self) -> Optional[int]:
    return self._mgr.latest_step()

  def restore(self, state_template: Any,
              step: Optional[int] = None) -> Any:
    """Restore into the template's shardings (possibly a different world
    size than the save — global shapes make this transparent). Missing
    keys keep the template's (freshly initialized) values.

    Layout-tolerant: a lane-packed table saved as ``[V/p, 128]`` and a
    template expecting ``[V, d]`` (or vice versa — the auto pack policy
    depends on world size, see ``TableConfig.pack_factor``) hold
    identical row-major bytes, so equal-size 2D leaves are restored in
    their STORED shape and reshaped into the template's.

    With option ``ckpt_grow_vocab`` (``HB_CKPT_GROW_VOCAB``), a SMALLER
    stored 2-D leaf warm-starts a grown template: stored rows fill the
    row prefix, the template's freshly-initialized tail provides the
    new vocabulary's rows (including optimizer slots, which grow the
    same way). Valid only for ``shuffle_ids=False`` tables."""
    if step is None:
      step = self._mgr.latest_step()
    if step is None:
      return state_template
    grow = bool(OPTIONS['ckpt_grow_vocab'])
    template = self._reshape_template(state_template, step, grow=grow)
    restored = self._mgr.restore(
        step, args=self._ocp.args.StandardRestore(template))
    restored = self._reshape_restored(restored, state_template, grow=grow)
    # Re-commit to the context mesh: restoring through a template whose
    # leaves were never mesh-placed yields single-device arrays that
    # clash with mesh-sharded batches under jit.
    from hybridbackend_tpu.training.train import replicate_over_mesh
    return replicate_over_mesh(restored)

  def _reshape_template(self, state_template: Any, step: int,
                        grow: bool = False) -> Any:
    """Swap equal-size shape-mismatched leaves for their stored shapes
    (no-op when everything matches, or when metadata can't be aligned
    — e.g. the template has extra keys the save lacks). With ``grow``,
    smaller 2-D stored leaves are also requested in their stored shape
    so the prefix fill can happen in ``_reshape_restored``."""
    import numpy as np
    try:
      meta = self._mgr.item_metadata(step)
      # Orbax wraps the metadata tree in its own custom node, so align
      # by flattened KEY PATH rather than tree structure (extra template
      # keys — the missing-key fallback — simply find no stored shape).
      stored = {jax.tree_util.keystr(p): tuple(m.shape)
                for p, m in jax.tree_util.tree_flatten_with_path(meta)[0]
                if getattr(m, 'shape', None) is not None}

      def _align(path, t):
        ts = tuple(getattr(t, 'shape', ()) or ())
        ms = stored.get(jax.tree_util.keystr(path))
        if ts and ms and ts != ms and np.prod(ms) == np.prod(ts):
          return jax.ShapeDtypeStruct(ms, t.dtype)
        if (grow and ts and ms and len(ts) == 2 and len(ms) == 2
            and np.prod(ms) < np.prod(ts)
            and np.prod(ms) % ts[-1] == 0):
          return jax.ShapeDtypeStruct(ms, t.dtype)
        return t

      return jax.tree_util.tree_map_with_path(_align, state_template)
    except Exception:  # noqa: BLE001 — metadata probing is best-effort
      return state_template

  @staticmethod
  def _reshape_restored(restored: Any, state_template: Any,
                        grow: bool = False) -> Any:
    """Reshape stored-layout leaves back into the template's shape and
    sharding (row-major reshape = the pack/unpack bijection). With
    ``grow``, a smaller stored 2-D leaf fills the template's row
    prefix; the template keeps its freshly-initialized tail. Row-major
    bytes make this layout-tolerant too: [V1, d] stored rows fill
    ``V1·d // minor`` rows of a lane-packed [V2/p, p·d] template (any
    non-divisible remainder — at most p-1 padding rows — is dropped)."""
    import jax.numpy as jnp

    def _back(r, t):
      tshape = tuple(getattr(t, 'shape', ()) or ())
      if not tshape or tuple(r.shape) == tshape:
        return r
      if r.size == int(jnp.prod(jnp.asarray(tshape))):
        r = r.reshape(tshape)
        if hasattr(t, 'sharding'):
          r = jax.device_put(r, t.sharding)
        return r
      if grow and len(tshape) == 2 and hasattr(t, 'at'):
        minor = tshape[-1]
        n_full = r.size // minor
        out = t.at[:n_full].set(
            r.reshape(-1)[:n_full * minor].reshape(n_full, minor)
            .astype(t.dtype))
        if hasattr(t, 'sharding'):
          out = jax.device_put(out, t.sharding)
        return out
      return r

    return jax.tree_util.tree_map(_back, restored, state_template)

  def all_steps(self):
    return self._mgr.all_steps()

  def close(self):
    self._mgr.close()


__all__ = ['CheckpointManager']
