"""Serving export via jax.export (SavedModel parity).

A JAX replacement for the reference's SavedModel export
(``/root/reference/hybridbackend/tensorflow/training/saved_model.py:54-192``):
rank0 builds a serving graph from the checkpoint and writes a
signature'd SavedModel. Here the serving function is serialized with
``jax.export`` (StableHLO, runnable by any XLA runtime) next to an
orbax checkpoint of the parameters.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

import jax
import numpy as np


def export(serving_fn: Callable[[Any, Dict[str, jax.Array]], jax.Array],
           params: Any, example_batch: Dict[str, Any], path: str,
           id_mappers: Dict[str, Any] = None,
           poly_batch: bool = False) -> str:
  """Serialize ``serving_fn(params, batch)`` + params under ``path``.

  Layout: ``<path>/serving_fn.bin`` (StableHLO via jax.export),
  ``<path>/params/`` (orbax), ``<path>/signature.json``, and — when
  ``id_mappers`` maps batch columns to
  :class:`~hybridbackend_tpu.embedding.dynamic.IdMapper` instances —
  ``<path>/id_mappers.npz`` with each mapper's full state, so a cold
  serving process resolves raw (unbounded) ids exactly as training did
  (reference: ``export_all`` bundles everything needed to serve from
  checkpoint, ``saved_model.py:54-192``).

  The exported signature treats every input as a dense array; ragged
  (sequence) features follow the padded+mask contract — a ``col`` of
  padded ids plus ``col_mask`` validity — and are recorded as such in
  ``signature.json``.

  ``poly_batch=True`` exports with a SYMBOLIC leading (batch) dimension
  on every batch input (jax.export shape polymorphism): one bundle
  serves any batch size — the reference SavedModel's dynamic-batch
  contract — at the cost of a per-concrete-size compile at serve time.
  """
  from jax import export as jax_export
  import orbax.checkpoint as ocp
  from hybridbackend_tpu.framework.context import (
      Context, build_mesh, context_scope)

  os.makedirs(path, exist_ok=True)
  # Flatten params for the serialized signature: checkpoint formats do
  # not preserve tuple-vs-list pytree nodes, so the exported function
  # takes the flat leaf list and rebuilds the structure internally.
  host_params = jax.tree_util.tree_map(np.asarray, params)
  leaves, treedef = jax.tree_util.tree_flatten(host_params)

  def flat_fn(leaf_list, batch):
    return serving_fn(jax.tree_util.tree_unflatten(treedef, leaf_list),
                      batch)

  # Serving is single-device: trace under a 1-device context so sharded
  # lookup paths degrade to local gathers (reference parity: rank0 builds
  # the serving graph from the merged checkpoint, ``saved_model.py:54``).
  one_dev = Context(build_mesh(devices=[jax.devices()[0]]))
  host_batch = {k: np.asarray(v) for k, v in example_batch.items()}
  with context_scope(one_dev):
    if poly_batch:
      bspecs = {k: ('b' + ', _' * (v.ndim - 1)) if v.ndim else None
                for k, v in host_batch.items()}
      specs = jax_export.symbolic_args_specs(
          (leaves, host_batch), (None, bspecs))
      exported = jax_export.export(jax.jit(flat_fn))(*specs)
    else:
      exported = jax_export.export(jax.jit(flat_fn))(leaves, host_batch)
  with open(os.path.join(path, 'serving_fn.bin'), 'wb') as f:
    f.write(exported.serialize())

  ckptr = ocp.StandardCheckpointer()
  ckptr.save(os.path.join(os.path.abspath(path), 'params', 'state'),
             leaves)
  ckptr.wait_until_finished()

  if id_mappers:
    blobs = {}
    meta = {}
    for col, mapper in id_mappers.items():
      state = mapper.state_dict()
      for k, v in state.items():
        blobs[f'{col}/{k}'] = np.asarray(v)
      meta[col] = {'capacity': mapper.capacity,
                   'min_count': mapper.min_count}
    np.savez(os.path.join(path, 'id_mappers.npz'), **blobs)
    with open(os.path.join(path, 'id_mappers.json'), 'w') as f:
      json.dump(meta, f)

  keys = set(example_batch)
  signature = {
      'inputs': {k: {'shape': (['b'] + list(np.asarray(v).shape[1:])
                               if poly_batch and np.asarray(v).ndim
                               else list(np.asarray(v).shape)),
                     'dtype': str(np.asarray(v).dtype)}
                 for k, v in example_batch.items()},
      'poly_batch': bool(poly_batch),
      # Padded+mask sequence contract (reference ragged serving inputs).
      'ragged': sorted(k for k in keys
                       if not k.endswith('_mask') and f'{k}_mask' in keys),
      'id_mapped': sorted(id_mappers) if id_mappers else [],
  }
  with open(os.path.join(path, 'signature.json'), 'w') as f:
    json.dump(signature, f, indent=2)
  return path


def load(path: str):
  """Load an exported model: returns ``(call(params, batch), params)``
  where ``params`` is the flat leaf list the export serialized."""
  from jax import export as jax_export
  import orbax.checkpoint as ocp

  with open(os.path.join(path, 'serving_fn.bin'), 'rb') as f:
    exported = jax_export.deserialize(f.read())
  ckptr = ocp.StandardCheckpointer()
  params = ckptr.restore(os.path.join(os.path.abspath(path), 'params',
                                      'state'))
  return exported.call, params


class Served:
  """A loaded export, ready to serve raw feature batches.

  Wraps the exported StableHLO function with the host-side input
  resolution the training pipeline performed: bundled ``IdMapper``
  states translate raw (unbounded) ids to table rows before the jitted
  call — the serving analogue of ``DynamicEmbedding.transform``.
  """

  def __init__(self, path: str):
    from hybridbackend_tpu.embedding.dynamic import IdMapper
    self._call, self._params = load(path)
    # Pin the parameters on device ONCE: leaving them as host arrays
    # makes every predict re-transfer the whole bundle. Transfer is
    # async — construction stays fast; the first predict waits for it.
    self._params = jax.device_put(self._params)
    with open(os.path.join(path, 'signature.json')) as f:
      self.signature = json.load(f)
    self._mappers = {}
    meta_p = os.path.join(path, 'id_mappers.json')
    if os.path.exists(meta_p):
      with open(meta_p) as f:
        meta = json.load(f)
      blobs = np.load(os.path.join(path, 'id_mappers.npz'))
      for col, m in meta.items():
        state = {k.split('/', 1)[1]: blobs[k] for k in blobs.files
                 if k.startswith(col + '/')}
        self._mappers[col] = IdMapper.from_state_dict(
            m['capacity'], state, min_count=m['min_count'])

  def stage(self, batch: Dict[str, np.ndarray]) -> Dict[str, jax.Array]:
    """Resolve ids, select/cast signature inputs, and place them on
    device — the input half of :meth:`predict`. A server that keeps
    request buffers device-adjacent stages once and calls
    :meth:`predict_staged` per dispatch."""
    batch = dict(batch)
    for col, mapper in self._mappers.items():
      batch[col] = mapper.map_ids(np.asarray(batch[col]), train=False)
    sig = self.signature['inputs']
    return {k: jax.device_put(np.asarray(v).astype(sig[k]['dtype']))
            for k, v in batch.items() if k in sig}

  def predict_staged(self, staged: Dict[str, jax.Array]) -> jax.Array:
    """Run the serving fn on :meth:`stage`-d inputs WITHOUT host
    round-trips: returns the device array (dispatch is async — read it
    back when needed). The amortized-latency path of
    ``benchmarks/serving_benchmark.py``."""
    return self._call(self._params, staged)

  def predict(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
    return np.asarray(self.predict_staged(self.stage(batch)))


__all__ = ['export', 'load', 'Served']
