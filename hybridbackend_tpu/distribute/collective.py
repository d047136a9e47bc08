"""Topology-aware collective communication over device meshes.

A JAX re-design of the reference's NCCL collective layer
(``/root/reference/hybridbackend/tensorflow/distribute/collective.py:37-549``
and ``distribute/nccl/*.cc``). Differences by design:

* There is no communicator resource, no RPC id broadcast, no handle
  linearization: XLA owns scheduling of collectives (NCCL on GPUs), and
  ``jax.distributed`` owns bootstrap. What remains is the *algebra*:
  allreduce / alltoall / alltoallv / allgather(v) / broadcast with
  topology selection (reference ``CollectiveTopology``,
  ``collective.h:52-112``) and wire-dtype compression (reference
  ``nccl_alltoallv.cc:331-339`` fp16-on-the-wire).
* The reference's grouped/merged N-ary packing passes
  (``optimize_collective.cc:94-163``) are unnecessary: XLA's collective
  combiners merge small collectives; explicit bucketing can be layered on
  if profiling demands it.

Two API levels:

1. **In-spmd primitives** (``psum_t``, ``all_to_all_t``, ...) — called
   inside ``shard_map``/``pjit`` bodies, parameterized by a
   :class:`Topology` that maps to mesh axis names.
2. **Array-level ops** (:func:`allreduce`, :func:`alltoall`, ...) —
   operate on global arrays sharded over the context mesh, mirroring
   ``hb.distribute.*`` (reference ``collective.py:485-549``), with
   custom gradients matching the reference (allreduce grad = allreduce,
   alltoallv grad = reverse alltoallv).
"""

from __future__ import annotations

import enum
import functools
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from hybridbackend_tpu.framework.context import (
    Context, DATA_AXIS, DCN_AXIS, ICI_AXIS)
from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('comm_wire_dtype', 'float32', env='HB_COMM_WIRE_DTYPE',
                 doc='On-the-wire dtype for forward collectives '
                     '(float32|bfloat16|float16).')
OPTIONS.register('comm_gradient_wire_dtype', 'float32',
                 env='HB_COMM_GRADIENT_WIRE_DTYPE',
                 doc='On-the-wire dtype for gradient collectives.')


class Topology(enum.IntEnum):
  """Which slice of the mesh a collective spans.

  Mirrors reference ``Topology`` (``distribute/ops.py:34-39``):
  ALL = every device; INTRA_NODE = devices sharing a host (ICI);
  INTER_NODE = one device per host position (DCN).
  """
  ALL = 0
  INTRA_NODE = 1
  INTER_NODE = 2


def topology_axes(topology: Topology = Topology.ALL,
                  ctx: Optional[Context] = None) -> Tuple[str, ...]:
  """Mesh axis names a collective should run over."""
  ctx = ctx or Context.get()
  names = tuple(ctx.mesh.axis_names)
  if topology == Topology.ALL:
    return names
  if topology == Topology.INTRA_NODE:
    return (ICI_AXIS,) if ICI_AXIS in names else names[-1:]
  if topology == Topology.INTER_NODE:
    return (DCN_AXIS,) if DCN_AXIS in names else names[:1]
  raise ValueError(f'Unknown topology: {topology}')


def _wire_dtype(name_or_dtype) -> jnp.dtype:
  if isinstance(name_or_dtype, str):
    return jnp.dtype(name_or_dtype)
  return jnp.dtype(name_or_dtype)


def _with_wire_cast(x: jax.Array, wire_dtype, fn):
  """Cast payload to the wire dtype around a collective (reference:
  CastIn/CastOut functors, ``nccl_alltoallv.cc:38-81``)."""
  if wire_dtype is None:
    return fn(x)
  wire = _wire_dtype(wire_dtype)
  orig = x.dtype
  if wire == orig or not jnp.issubdtype(orig, jnp.floating):
    return fn(x)
  return fn(x.astype(wire)).astype(orig)


# ---------------------------------------------------------------------------
# Level 1: primitives for use inside shard_map / pjit bodies.
# ---------------------------------------------------------------------------

AxisNames = Union[str, Tuple[str, ...]]


def psum_t(x, axes: AxisNames, wire_dtype=None):
  return _with_wire_cast(x, wire_dtype, lambda v: jax.lax.psum(v, axes))


def pmean_t(x, axes: AxisNames, wire_dtype=None):
  return _with_wire_cast(x, wire_dtype, lambda v: jax.lax.pmean(v, axes))


def pmax_t(x, axes: AxisNames):
  return jax.lax.pmax(x, axes)


def pmin_t(x, axes: AxisNames):
  return jax.lax.pmin(x, axes)


def all_gather_t(x, axes: AxisNames, axis: int = 0, tiled: bool = False,
                 wire_dtype=None):
  return _with_wire_cast(
      x, wire_dtype,
      lambda v: jax.lax.all_gather(v, axes, axis=axis, tiled=tiled))


def psum_scatter_t(x, axes: AxisNames, axis: int = 0, tiled: bool = False,
                   wire_dtype=None):
  return _with_wire_cast(
      x, wire_dtype,
      lambda v: jax.lax.psum_scatter(v, axes, scatter_dimension=axis,
                                     tiled=tiled))


def all_to_all_t(x, axes: AxisNames, split_axis: int = 0,
                 concat_axis: int = 0, tiled: bool = False, wire_dtype=None):
  return _with_wire_cast(
      x, wire_dtype,
      lambda v: jax.lax.all_to_all(v, axes, split_axis=split_axis,
                                   concat_axis=concat_axis, tiled=tiled))


def broadcast_t(x, axes: AxisNames, root: int = 0):
  """Broadcast ``root``'s value to every member along ``axes``.

  Reference: ``HbNcclBroadcast`` (``nccl_broadcast.cc:31-90``). Here we
  express it as a masked psum, which XLA lowers to an efficient broadcast.
  """
  axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
  idx = 0
  size = 1
  for a in axes_t:
    idx = idx * jax.lax.axis_size(a) + jax.lax.axis_index(a)
    size *= jax.lax.axis_size(a)
  mask = (idx == root).astype(x.dtype if jnp.issubdtype(x.dtype, jnp.floating)
                              else jnp.float32)
  if jnp.issubdtype(x.dtype, jnp.floating):
    return jax.lax.psum(x * mask, axes_t)
  # Integer payloads: psum in int space.
  return jax.lax.psum(jnp.where(idx == root, x, jnp.zeros_like(x)), axes_t)


def axis_index_t(axes: AxisNames) -> jax.Array:
  """Linearized index of this shard along ``axes``."""
  axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
  idx = jnp.int32(0)
  for a in axes_t:
    idx = idx * jax.lax.axis_size(a) + jax.lax.axis_index(a)
  return idx


def axis_size_t(axes: AxisNames) -> int:
  axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
  size = 1
  for a in axes_t:
    size *= jax.lax.axis_size(a)
  return size


def all_to_all_v_t(buckets: jax.Array, sizes: jax.Array, axes: AxisNames,
                   wire_dtype=None) -> Tuple[jax.Array, jax.Array]:
  """Static-shape alltoallv: exchange per-peer buckets and their sizes.

  The reference implements alltoallv by first alltoall-exchanging int32
  sizes, then moving exactly-sized payloads via paired ncclSend/ncclRecv
  (``nccl_alltoallv.cc:200-350``). XLA requires static shapes, so the
  static-shape protocol exchanges *fixed-capacity buckets*:

  Args:
    buckets: ``[world, capacity, ...]`` — row ``i`` is the (padded)
      payload destined to peer ``i``.
    sizes: ``[world]`` int32 — valid rows in each bucket.

  Returns:
    ``(recv_buckets [world, capacity, ...], recv_sizes [world])`` where
    ``recv_buckets[j]`` is the payload sent by peer ``j`` to this device.
  """
  recv_sizes = jax.lax.all_to_all(sizes, axes, split_axis=0, concat_axis=0,
                                  tiled=True)
  recv = _with_wire_cast(
      buckets, wire_dtype,
      lambda v: jax.lax.all_to_all(v, axes, split_axis=0, concat_axis=0,
                                   tiled=False))
  # all_to_all with tiled=False on [world, cap, ...] splits axis0 into
  # world chunks of size 1 and concatenates along axis0 → [world, cap, ...].
  return recv, recv_sizes


# ---------------------------------------------------------------------------
# Level 2: array-level API over the context mesh (hb.distribute.* parity).
# ---------------------------------------------------------------------------

def _spmd(fn, in_specs, out_specs, ctx: Optional[Context] = None):
  ctx = ctx or Context.get()
  # check_vma=False: collectives like all_gather produce values that ARE
  # replicated but whose replication the varying-axes checker cannot
  # statically prove.
  return jax.shard_map(fn, mesh=ctx.mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)


def allreduce(value: jax.Array, reduction: str = 'sum',
              topology: Topology = Topology.ALL,
              ctx: Optional[Context] = None) -> jax.Array:
  """Allreduce a replicated array across the mesh.

  Reference: ``hb.distribute.allreduce`` (``collective.py:485-504``); its
  custom gradient (grad is allreduced too, ``collective.py:192-209``) falls
  out of JAX autodiff of psum automatically.
  """
  ctx = ctx or Context.get()
  axes = topology_axes(topology, ctx)
  red = {'sum': psum_t, 'max': pmax_t, 'min': pmin_t, 'mean': pmean_t}
  if reduction not in red:
    raise ValueError(f'Unsupported reduction: {reduction}')
  fn = functools.partial(red[reduction], axes=axes)
  return _spmd(fn, P(), P(), ctx)(value)


def broadcast(value: jax.Array, root: int = 0,
              topology: Topology = Topology.ALL,
              ctx: Optional[Context] = None) -> jax.Array:
  """Broadcast the root device's copy of a replicated array."""
  ctx = ctx or Context.get()
  axes = topology_axes(topology, ctx)
  fn = functools.partial(broadcast_t, axes=axes, root=root)
  return jax.lax.stop_gradient(_spmd(fn, P(), P(), ctx)(value))


def allgather(value: jax.Array, topology: Topology = Topology.ALL,
              ctx: Optional[Context] = None) -> jax.Array:
  """Gather batch-sharded shards into a replicated concatenation.

  Reference: ``hb.distribute.allgather`` (``collective.py:524-536``);
  like the reference, gradients are stopped.
  """
  ctx = ctx or Context.get()
  axes = topology_axes(topology, ctx)
  fn = functools.partial(all_gather_t, axes=axes, axis=0, tiled=True)
  out = _spmd(fn, P(ctx.data_axes), P(), ctx)(value)
  return jax.lax.stop_gradient(out)


def alltoall(value: jax.Array, topology: Topology = Topology.ALL,
             ctx: Optional[Context] = None,
             wire_dtype=None) -> jax.Array:
  """All-to-all exchange along the leading (sharded) axis.

  Each device's shard ``[world, ...]`` row ``i`` goes to device ``i``.
  Reference: ``hb.distribute.alltoall`` (``collective.py:509-521``).
  """
  ctx = ctx or Context.get()
  axes = topology_axes(topology, ctx)
  if wire_dtype is None:
    wire_dtype = OPTIONS['comm_wire_dtype']
  fn = functools.partial(all_to_all_t, axes=axes, split_axis=0,
                         concat_axis=0, tiled=True, wire_dtype=wire_dtype)
  return _spmd(fn, P(ctx.data_axes), P(ctx.data_axes), ctx)(value)


def _norm_wire(wire_dtype):
  if wire_dtype is None:
    wire_dtype = OPTIONS['comm_wire_dtype']
  return None if wire_dtype in ('float32', '', None) else \
      jnp.dtype(wire_dtype)


def alltoallv(value: jax.Array, sizes: jax.Array,
              topology: Topology = Topology.ALL,
              ctx: Optional[Context] = None,
              wire_dtype=None) -> Tuple[jax.Array, jax.Array]:
  """Variable-size all-to-all over static-capacity buckets.

  Array-level lift of :func:`all_to_all_v_t` — the static-shape form of the
  reference ``hb.distribute.alltoall(value, sizes=...)``
  (``collective.py:485-549`` / ``nccl_alltoallv.cc:200-350``).

  Args:
    value: global ``[W, W, cap, *common]`` array sharded on axis 0.
      Device ``i``'s local ``[W, cap, ...]`` block holds its per-peer
      buckets: row ``j`` goes to peer ``j``, first ``sizes[i, j]`` rows
      valid.
    sizes: global ``[W, W]`` int32, sharded on axis 0.

  Returns:
    ``(received, received_sizes)`` with the same global shapes: device
    ``i``'s local row ``j`` is the bucket peer ``j`` sent to ``i``.

  Gradients match the reference protocol (``collective.py:326-350``):
  the cotangent is routed back with a REVERSE alltoallv using the
  exchanged sizes, in ``comm_gradient_wire_dtype`` on the wire.
  """
  ctx = ctx or Context.get()
  axes = topology_axes(topology, ctx)
  wire = _norm_wire(wire_dtype)
  gwire = _norm_wire(OPTIONS['comm_gradient_wire_dtype'])

  def body(v, s):
    v = v.reshape(v.shape[1:])          # strip the sharded leading dim
    s = s.reshape(s.shape[1:])

    @jax.custom_vjp
    def exchange(v):
      recv, rs = all_to_all_v_t(v, s, axes, wire_dtype=wire)
      return recv, rs

    def fwd(v):
      recv, rs = all_to_all_v_t(v, s, axes, wire_dtype=wire)
      return (recv, rs), rs

    def bwd(rs, ct):
      drecv, _ = ct
      back, _ = all_to_all_v_t(drecv, rs, axes, wire_dtype=gwire)
      return (back,)

    exchange.defvjp(fwd, bwd)
    recv, rs = exchange(v)
    return recv[None], rs[None]

  spec = P(ctx.data_axes)
  return _spmd(body, (spec, spec), (spec, spec), ctx)(value, sizes)


def allgatherv(value: jax.Array, sizes: jax.Array,
               topology: Topology = Topology.ALL,
               ctx: Optional[Context] = None
               ) -> Tuple[jax.Array, jax.Array]:
  """Gather variable-size per-device shards to every device.

  Reference: ``hb.distribute.allgather(value, varying_size=True)``
  (``collective.py:536-549``). Static-shape contract: device ``i``
  contributes its local ``[cap, ...]`` block of which the first
  ``sizes[i]`` rows are valid.

  Args:
    value: global ``[W, cap, *common]`` array sharded on axis 0.
    sizes: global ``[W]`` int32 sharded on axis 0.

  Returns:
    ``(gathered [W, cap, ...], sizes [W])`` replicated on every device.
    Use :func:`compact_rows` to front-pack the valid rows. Gradients are
    stopped (reference allgather contract).
  """
  ctx = ctx or Context.get()
  axes = topology_axes(topology, ctx)

  def body(v, s):
    return (jax.lax.all_gather(v.reshape(v.shape[1:]), axes, tiled=False),
            jax.lax.all_gather(s, axes, tiled=True))

  out, szs = _spmd(body, (P(ctx.data_axes), P(ctx.data_axes)),
                   (P(), P()), ctx)(value, sizes)
  return jax.lax.stop_gradient(out), szs


def compact_rows(gathered: jax.Array, sizes: jax.Array
                 ) -> Tuple[jax.Array, jax.Array]:
  """Front-pack the valid rows of ``[W, cap, ...]`` buckets.

  Returns ``(flat [W*cap, ...], valid [W*cap] bool)`` where the first
  ``sum(sizes)`` rows are the valid rows in (device, lane) order — the
  static-shape analogue of the reference allgatherv's concatenated
  output.
  """
  w, cap = gathered.shape[:2]
  lane_valid = (jnp.arange(cap)[None, :] < sizes[:, None]).reshape(-1)
  order = jnp.argsort(~lane_valid, stable=True)
  flat = gathered.reshape((w * cap,) + gathered.shape[2:])[order]
  count = jnp.sum(sizes)
  return flat, jnp.arange(w * cap) < count


__all__ = [
    'Topology', 'topology_axes',
    'psum_t', 'pmean_t', 'pmax_t', 'pmin_t', 'all_gather_t',
    'psum_scatter_t', 'all_to_all_t', 'all_to_all_v_t', 'broadcast_t',
    'axis_index_t', 'axis_size_t',
    'allreduce', 'broadcast', 'allgather', 'alltoall', 'alltoallv',
    'allgatherv', 'compact_rows',
]
