"""Cluster/topology context for device meshes.

A JAX re-design of the reference's ``Context`` singleton
(``/root/reference/hybridbackend/tensorflow/framework/context.py:47-461``).
The reference parses ``TF_CONFIG`` to learn cluster membership and exposes
``rank``/``world_size``/``local_world_size``; here, cluster membership
comes from ``jax.distributed`` / the PJRT runtime, and the unit of
parallelism is a :class:`jax.sharding.Mesh` rather than per-process GPUs.

The context owns:

* the device mesh — by default a 2-level mesh ``('dcn', 'ici')`` where
  ``dcn`` spans processes (hosts / pod slices, reference topology
  ``INTER_NODE``) and ``ici`` spans the devices of one process
  (reference ``INTRA_NODE``; see ``distribute/collective.h:52-112``);
* rank / world-size accessors mirroring the reference API;
* the flattened 1-D ``'data'`` view used for plain data parallelism and
  row-sharded embeddings.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hybridbackend_tpu.framework.options import OPTIONS

# Canonical mesh axis names.
DCN_AXIS = 'dcn'     # across hosts / slices (reference: INTER_NODE)
ICI_AXIS = 'ici'     # within a host / slice (reference: INTRA_NODE)
DATA_AXIS = 'data'   # flat data-parallel axis = ('dcn', 'ici') collapsed


def build_mesh(devices: Optional[Sequence[jax.Device]] = None,
               hierarchical: Optional[bool] = None) -> Mesh:
  """Build the canonical device mesh.

  When ``hierarchical`` (default: auto — true iff >1 process), the mesh is
  2-D ``(dcn, ici)`` with ``dcn`` = number of processes. Otherwise it is a
  2-D mesh with ``dcn=1`` so downstream code can always address both axes.
  """
  if devices is None:
    devices = jax.devices()
  devices = list(devices)
  n = len(devices)
  num_procs = max(1, len({d.process_index for d in devices}))
  if hierarchical is None:
    hierarchical = num_procs > 1
  dcn = num_procs if hierarchical else 1
  if n % dcn != 0:
    dcn = 1
  ici = n // dcn
  # Sort so devices of one process are contiguous along the ici axis.
  devices = sorted(devices, key=lambda d: (d.process_index, d.id))
  arr = np.array(devices).reshape(dcn, ici)
  return Mesh(arr, (DCN_AXIS, ICI_AXIS))


class Context:
  """Topology context: mesh + rank/world accessors.

  Unlike the reference singleton, contexts are ordinary objects; a default
  context is lazily created from all visible devices and can be replaced
  within a scope via :func:`context_scope`.
  """

  _lock = threading.Lock()
  _default: Optional['Context'] = None
  _scoped = threading.local()

  def __init__(self, mesh: Optional[Mesh] = None):
    self._mesh = mesh if mesh is not None else build_mesh()

  # -- topology ----------------------------------------------------------
  @property
  def mesh(self) -> Mesh:
    return self._mesh

  @property
  def data_axes(self) -> Tuple[str, ...]:
    """Mesh axes that together form the data-parallel world."""
    return tuple(self._mesh.axis_names)

  @property
  def world_size(self) -> int:
    """Total number of participating devices (reference: world_size over
    GPUs; here: devices on the data axes)."""
    return int(np.prod([self._mesh.shape[a] for a in self.data_axes]))

  @property
  def num_hosts(self) -> int:
    return int(self._mesh.shape.get(DCN_AXIS, 1))

  @property
  def local_world_size(self) -> int:
    return int(self._mesh.shape.get(ICI_AXIS, self.world_size))

  @property
  def rank(self) -> int:
    """Process index (host rank). Reference: Context.rank."""
    return jax.process_index()

  @property
  def num_processes(self) -> int:
    return jax.process_count()

  @property
  def is_chief(self) -> bool:
    return self.rank == 0

  # -- shardings ---------------------------------------------------------
  def sharding(self, *spec) -> NamedSharding:
    return NamedSharding(self._mesh, P(*spec))

  @property
  def batch_spec(self) -> P:
    """PartitionSpec sharding a leading batch dim over the full world."""
    return P(self.data_axes)

  @property
  def batch_sharding(self) -> NamedSharding:
    return NamedSharding(self._mesh, self.batch_spec)

  @property
  def replicated_sharding(self) -> NamedSharding:
    return NamedSharding(self._mesh, P())

  @property
  def table_spec(self) -> P:
    """PartitionSpec row-sharding an embedding table over the world."""
    return P(self.data_axes)

  def __repr__(self) -> str:
    return (f'Context(mesh={dict(self._mesh.shape)}, rank={self.rank}, '
            f'world_size={self.world_size})')

  # -- default / scoping --------------------------------------------------
  @classmethod
  def get(cls) -> 'Context':
    stack = getattr(cls._scoped, 'stack', None)
    if stack:
      return stack[-1]
    with cls._lock:
      if cls._default is None:
        cls._default = Context()
      return cls._default

  @classmethod
  def reset(cls) -> None:
    with cls._lock:
      cls._default = None


@contextlib.contextmanager
def context_scope(ctx: Context) -> Iterator[Context]:
  """Make ``ctx`` the current context within the scope."""
  stack = getattr(Context._scoped, 'stack', None)
  if stack is None:
    stack = Context._scoped.stack = []
  stack.append(ctx)
  try:
    yield ctx
  finally:
    stack.pop()


@contextlib.contextmanager
def scope(**kwargs) -> Iterator[Context]:
  """Functional analogue of the reference's ``hb.scope(**options)``
  (``rewriting.py:105-110``): pushes option overrides and yields the
  current context. No graph rewriting happens (none is needed in JAX)."""
  with OPTIONS.override(**kwargs):
    yield Context.get()


@contextlib.contextmanager
def embedding_scope(sharded: bool = True, **kwargs) -> Iterator[Context]:
  """Analogue of the reference's ``hb.embedding_scope()``
  (``tensorflow/__init__.py:58-64``), which marks tables built inside it
  for sharding. While the scope is active, auto-policy tables
  (``TableConfig`` without an explicit ``sharded=``) follow the scope's
  policy; extra kwargs override any ``emb_*`` option (e.g.
  ``emb_lookup_strategy='alltoall'``).

  The policy is scope-scoped, not creation-scoped: lookups must run
  under the same scope (or options) as table creation. To bake the
  policy into the config at creation time, use
  ``TableConfig.resolve()`` inside the scope."""
  with OPTIONS.override(emb_sharded=sharded, **kwargs):
    yield Context.get()
