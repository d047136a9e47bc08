"""HBM-cached embeddings over host-DRAM tables (EmbeddingService parity).

A JAX re-design of the reference's GPU-cached ``EmbeddingService``
(``/root/reference/hybridbackend/tensorflow/embedding/service.py:50-324``
+ WCWS slab-hash probe kernel ``lookup_functors.cu.cc:40-170``): tables
too large for device memory live in host DRAM (or any KV store behind
:class:`Storage`); the device holds a fixed-capacity row cache. The
reference probes a GPU hash table with a warp-cooperative kernel and
evicts by staleness top-k; here the id→slot map is the native
open-addressing hash on the host input path
(:class:`hybridbackend_tpu.native.NativeIdMap` — the input pipeline
already touches every id there), so the device only ever sees dense slot
indices and the training step stays a pure jitted function over the
cache array.

The cache is split into a **plan** phase (pure metadata: slot
assignment, LRU eviction choice — safe to run ahead in the prefetch
producer thread) and an **apply** phase (array effects: write back
evicted rows, upload missing rows — executed in plan order by the
training loop against the CURRENT state arrays). This ordering makes
cache maintenance correct under prefetch pipelining: an evicted slot's
write-back always reads the post-update array of the last step that
could have touched it.

``SparseTrainer(caches=...)`` wires a cache in as a first-class table
kind: the cached table is an ordinary (stackable, shardable) fx table of
``capacity`` rows; batch ids are host-mapped to slots, and the plan's
array effects are applied to the live training state each step
(reference ``before_apply_gradients`` / ``before_save_checkpoints``
hooks, ``service.py:253-324``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hybridbackend_tpu.embedding.table import TableConfig
from hybridbackend_tpu.framework.context import Context


class Storage:
  """Abstract row storage behind the cache (reference
  ``EmbeddingService.pull/push``, ``service.py:143-149``): implement
  against any KV store / parameter service. Rows are keyed by table row
  index; a storage serves one logical table (+ aligned aux tables via
  separate instances or the ``name`` argument)."""

  def pull(self, name: str, keys: np.ndarray) -> np.ndarray:
    """Fetch rows ``keys`` of table ``name`` → ``[len(keys), ...]``."""
    raise NotImplementedError

  def push(self, name: str, keys: np.ndarray,
           values: np.ndarray) -> None:
    """Write rows ``keys`` of table ``name``."""
    raise NotImplementedError


class InMemoryStorage(Storage):
  """Default storage: plain host-DRAM arrays."""

  def __init__(self, tables: Dict[str, np.ndarray]):
    self.tables = tables

  def pull(self, name, keys):
    return self.tables[name][keys]

  def push(self, name, keys, values):
    self.tables[name][keys] = values


class CachePlan(NamedTuple):
  """Metadata result of one ``prepare_plan`` call.

  Attributes:
    slots: slot index per input id (input shape), int32.
    evict_slots / evict_ids: rows to write back BEFORE the upload.
    miss_slots / miss_ids: rows to pull from storage into the cache.
  """
  slots: np.ndarray
  evict_slots: np.ndarray
  evict_ids: np.ndarray
  miss_slots: np.ndarray
  miss_ids: np.ndarray


class EmbeddingCache:
  """Fixed-capacity device cache over one host-DRAM table (plus aligned
  auxiliary tables, e.g. optimizer slot accumulators).

  The id→slot map runs in the native hash (NumPy-unique + dict fallback
  touching only unique ids); LRU eviction and slot bookkeeping are fully
  vectorized — no per-id Python loops anywhere.
  """

  def __init__(self, config: TableConfig, capacity: int,
               host_tables: Optional[Dict[str, np.ndarray]] = None,
               storage: Optional[Storage] = None,
               table_shapes: Optional[Dict[str, tuple]] = None,
               table_dtypes: Optional[Dict[str, np.dtype]] = None,
               ctx: Optional[Context] = None):
    from hybridbackend_tpu import native
    self.config = config
    self._ctx = ctx or Context.get()
    if host_tables is None and storage is None:
      raise ValueError('pass host_tables or a Storage')
    if host_tables is not None and storage is not None:
      raise ValueError('pass host_tables OR storage, not both (seed a '
                       'custom Storage with the initial rows instead)')
    if host_tables is not None:
      if 'value' not in host_tables:
        raise ValueError("host_tables must include a 'value' table")
      vocab = host_tables['value'].shape[0]
      for name, t in host_tables.items():
        if t.shape[0] != vocab:
          raise ValueError(
              f'host table {name!r} rows {t.shape[0]} != {vocab}')
      storage = InMemoryStorage(host_tables)
      table_shapes = {n: t.shape[1:] for n, t in host_tables.items()}
      table_dtypes = {n: t.dtype for n, t in host_tables.items()}
    else:
      if not table_shapes or 'value' not in table_shapes:
        raise ValueError("storage mode needs table_shapes with 'value'")
      table_dtypes = {**{n: np.dtype(np.float32) for n in table_shapes},
                      **(table_dtypes or {})}
    self.storage = storage
    self.capacity = int(capacity)
    self.host: Dict[str, np.ndarray] = host_tables or {}
    # Device-resident caches, one per table, same slot mapping. Placed
    # row-sharded over the mesh when the slot table's shard policy says
    # so (standalone use; via SparseTrainer the arrays ARE the sharded
    # training tables and this dict is only the default home).
    slot_cfg = self.slot_config()
    shard = (slot_cfg.should_shard(self._ctx)
             and self.capacity % max(self._ctx.world_size, 1) == 0)
    self.device: Dict[str, jax.Array] = {}
    for name, shape in table_shapes.items():
      z = jnp.zeros((self.capacity,) + tuple(shape), table_dtypes[name])
      if shard:
        z = jax.device_put(z, self._ctx.sharding(
            self._ctx.data_axes, *([None] * len(shape))))
      self.device[name] = z
    import threading
    # Guards all slot metadata (native hash, _slot_to_id, _last_used,
    # free list): prepare_plan runs in the prefetch producer thread
    # while lookup_slots (eval) and flush (checkpoints) read from other
    # threads — an unlocked native-hash grow during a concurrent probe
    # would be a use-after-free.
    self._meta_lock = threading.Lock()
    self._slots = native.native_idmap(min(self.capacity, 1 << 20))
    self._fallback: Dict[int, int] = {} if self._slots is None else None
    self._slot_to_id = np.full(self.capacity, -1, np.int64)
    self._last_used = np.zeros(self.capacity, np.int64)
    self._n_free = self.capacity          # slots [n_used:] conceptually
    self._free = np.arange(self.capacity - 1, -1, -1, dtype=np.int64)
    self._step = 0

  def slot_config(self) -> TableConfig:
    """TableConfig of the slot space — use it to declare the cached
    table to a feature extractor (``vocab = capacity``; slots are dense,
    so no id mixing)."""
    import dataclasses
    return dataclasses.replace(self.config, vocab_size=self.capacity,
                               shuffle_ids=False, lane_pack=False)

  @property
  def resident(self) -> int:
    return int((self._slot_to_id >= 0).sum())

  # -- id -> slot map (native hash; unique+dict fallback) ------------------

  def _lookup_slots(self, uniq: np.ndarray) -> np.ndarray:
    if self._slots is not None:
      return self._slots.lookup(uniq).astype(np.int64)
    return np.asarray([self._fallback.get(int(i), -1) for i in uniq],
                      np.int64)

  def _set_slots(self, ids: np.ndarray, slots: np.ndarray) -> None:
    if self._slots is not None:
      self._slots.set(ids, slots.astype(np.int32))
    else:
      for i, s in zip(ids.tolist(), slots.tolist()):
        self._fallback[int(i)] = int(s)

  def _erase_slots(self, ids: np.ndarray) -> None:
    if self._slots is not None:
      self._slots.erase(ids)
    else:
      for i in ids.tolist():
        self._fallback.pop(int(i), None)

  # -- plan / apply --------------------------------------------------------

  def prepare_plan(self, ids: np.ndarray) -> CachePlan:
    """Assign slots for ``ids`` (metadata only; no array effects).

    Safe to call from a prefetch producer thread; the returned plans
    must be APPLIED in creation order (see module docstring).
    """
    with self._meta_lock:
      return self._prepare_plan_locked(ids)

  def _prepare_plan_locked(self, ids: np.ndarray) -> CachePlan:
    shape = np.asarray(ids).shape
    flat = np.asarray(ids).reshape(-1)
    uniq, inverse = np.unique(flat, return_inverse=True)
    if len(uniq) > self.capacity:
      raise ValueError(
          f'batch touches {len(uniq)} unique ids > capacity '
          f'{self.capacity}; raise the cache capacity')
    self._step += 1
    slots_u = self._lookup_slots(uniq)
    miss_mask = slots_u < 0
    misses = uniq[miss_mask]
    evict_slots = np.zeros((0,), np.int64)
    evict_ids = np.zeros((0,), np.int64)
    if misses.size:
      new_slots, evict_slots, evict_ids = self._allocate(
          len(misses), protect_slots=slots_u[~miss_mask])
      self._erase_slots(evict_ids)
      self._set_slots(misses, new_slots)
      self._slot_to_id[new_slots] = misses
      slots_u = slots_u.copy()
      slots_u[miss_mask] = new_slots
    self._last_used[slots_u] = self._step
    return CachePlan(
        slots=slots_u[inverse].astype(np.int32).reshape(shape),
        evict_slots=evict_slots, evict_ids=evict_ids,
        miss_slots=slots_u[miss_mask], miss_ids=misses)

  def _allocate(self, n: int, protect_slots: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Take ``n`` slots: free ones first, then stalest residents
    (reference staleness top-k eviction, ``service.py:253-283``)."""
    take = min(self._n_free, n)
    slots = self._free[self._n_free - take:self._n_free].copy()
    self._n_free -= take
    if take == n:
      return slots, np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    need = n - take
    order = np.argsort(self._last_used, kind='stable')
    prot = np.zeros(self.capacity, bool)
    prot[protect_slots] = True
    cand = order[(self._slot_to_id[order] >= 0) & ~prot[order]]
    if len(cand) < need:
      raise ValueError('cache thrash: cannot evict enough rows')
    evict = cand[:need]
    evict_ids = self._slot_to_id[evict].copy()
    self._slot_to_id[evict] = -1
    return np.concatenate([slots, evict]), evict, evict_ids

  def apply_plan(self, arrays: Dict[str, jax.Array], plan: CachePlan,
                 row_offset: int = 0) -> Dict[str, jax.Array]:
    """Execute a plan's array effects against ``arrays`` (keys must
    match the cache's table names; ``row_offset`` shifts slot indices —
    used when the cached table is a member of a stacked physical
    table). Returns the updated arrays."""
    if plan.evict_slots.size:
      rows_idx = jnp.asarray(plan.evict_slots + row_offset)
      for name, arr in arrays.items():
        rows = np.asarray(jnp.take(arr, rows_idx, axis=0))
        self.storage.push(name, plan.evict_ids, rows)
    if plan.miss_slots.size:
      slots_idx = jnp.asarray(plan.miss_slots + row_offset)
      out = {}
      for name, arr in arrays.items():
        rows = jnp.asarray(self.storage.pull(name, plan.miss_ids),
                           arr.dtype)
        out[name] = arr.at[slots_idx].set(rows)
      return out
    return dict(arrays)

  # -- single-array convenience (standalone use, tests) --------------------

  def prepare(self, ids: np.ndarray) -> np.ndarray:
    """Plan + apply against the cache's own device arrays; returns slot
    indices. Call once per step BEFORE the jitted step."""
    plan = self.prepare_plan(ids)
    self.device = self.apply_plan(self.device, plan)
    return plan.slots

  def flush(self, arrays: Optional[Dict[str, jax.Array]] = None,
            row_offset: int = 0) -> None:
    """Write every resident row back to storage (reference
    ``before_save_checkpoints``, ``service.py:306-324``)."""
    arrays = self.device if arrays is None else arrays
    with self._meta_lock:
      resident = np.nonzero(self._slot_to_id >= 0)[0]
      if not resident.size:
        return
      owners = self._slot_to_id[resident].copy()
    idx = jnp.asarray(resident + row_offset)
    for name, arr in arrays.items():
      rows = np.asarray(jnp.take(arr, idx, axis=0))
      self.storage.push(name, owners, rows)

  def lookup_slots(self, ids: np.ndarray) -> np.ndarray:
    """Read-only id→slot probe (eval: misses → -1 → zero embeddings)."""
    shape = np.asarray(ids).shape
    flat = np.asarray(ids).reshape(-1)
    uniq, inverse = np.unique(flat, return_inverse=True)
    with self._meta_lock:
      slots = self._lookup_slots(uniq)
    return slots[inverse].astype(np.int32).reshape(shape)

  def lookup_embeddings(self, slots: np.ndarray) -> jax.Array:
    """Convenience: gather cached value rows for prepared slots."""
    return jnp.take(self.device['value'], jnp.asarray(slots), axis=0)


class CacheRunner:
  """Wires :class:`EmbeddingCache` instances into a training loop.

  One runner serves a SparseTrainer: ``transform`` (producer thread)
  plans slot assignments and rewrites id columns to slots; the trainer
  calls ``apply_next`` before each step to execute the oldest plan's
  array effects against the live state (plan order = step order, which
  is what makes write-backs read fully-updated rows), and ``flush``
  before checkpoints.
  """

  def __init__(self, caches: Dict[str, 'EmbeddingCache'], fx):
    import collections
    import threading
    self._caches = dict(caches)
    self._plans = collections.deque()
    # Spans plan CREATION + queue append so checkpoint_flush can take an
    # atomic (pending plans, slot metadata) snapshot while the producer
    # thread keeps planning.
    self._runner_lock = threading.Lock()
    self._loc: Dict[str, Tuple[str, int]] = {}
    for col, cache in self._caches.items():
      name = cache.config.name
      stack = fx._stack_of[name]
      _, off = stack.member(name)
      self._loc[col] = (stack.stacked.name, off)

  def transform(self, batch):
    """Producer-side: map id columns to cache slots, queue the plan."""
    batch = dict(batch)
    with self._runner_lock:
      plans = {}
      for col, cache in self._caches.items():
        plan = cache.prepare_plan(np.asarray(batch[col]))
        batch[col] = plan.slots
        plans[col] = plan
      self._plans.append(plans)
    return batch

  def eval_transform(self, batch):
    """Read-only slot mapping for eval/predict: misses → -1 (cold ids
    read as zeros by the lookup out-of-range contract).

    Mid-train (prefetch depth ≥ 1) the live id→slot map already includes
    QUEUED plans whose uploads have not been applied to the arrays yet —
    resolving against it would read slots still holding the evicted
    previous owner's rows. Slots are therefore resolved against the
    metadata state REWOUND past every pending plan (the same undo-replay
    as :meth:`checkpoint_flush`): an id whose slot assignment is still
    pending reads as a miss (-1), and an id whose eviction is still
    pending reads its ORIGINAL slot (whose row it still owns)."""
    batch = dict(batch)
    with self._runner_lock:
      pending = list(self._plans)
      for col, cache in self._caches.items():
        ids = np.asarray(batch[col])
        live = cache.lookup_slots(ids)
        if not pending:
          batch[col] = live
          continue
        # Slots (re)assigned by pending uploads: arrays not updated yet.
        planned = set()
        # First pending eviction per slot names the TRUE current owner.
        restore: Dict[int, int] = {}
        seen_slots = set()
        for plans in pending:
          plan = plans.get(col)
          if plan is None:
            continue
          for s, i in zip(plan.evict_slots.tolist(),
                          plan.evict_ids.tolist()):
            first_evict_of_slot = s not in seen_slots
            seen_slots.add(s)
            # Only an id's FIRST pending eviction names a slot whose
            # rows it still owns in the arrays. A later eviction of the
            # same id (evict → re-admit → evict again, all pending)
            # refers to a slot the unapplied re-admission assigned —
            # the arrays never held the id there.
            if first_evict_of_slot and int(i) not in restore:
              restore[int(i)] = int(s)
          planned.update(plan.miss_slots.tolist())
        shape = ids.shape
        flat = ids.reshape(-1).astype(np.int64)
        out = live.reshape(-1).astype(np.int32).copy()
        if planned:
          out[np.isin(out, np.fromiter(planned, np.int32))] = -1
        if restore:
          rids = np.fromiter(restore.keys(), np.int64)
          rslots = np.fromiter(restore.values(), np.int32)
          order = np.argsort(rids)
          rids, rslots = rids[order], rslots[order]
          pos = np.clip(np.searchsorted(rids, flat), 0, len(rids) - 1)
          hit = rids[pos] == flat
          out[hit] = rslots[pos[hit]]
        batch[col] = out.reshape(shape)
    return batch

  @staticmethod
  def _build_arrays(table, accs) -> Dict[str, jax.Array]:
    arrays = {'value': table}
    arrays.update({f'slot{i}': a for i, a in enumerate(accs)})
    return arrays

  def _arrays_of(self, state, sname: str) -> Dict[str, jax.Array]:
    return self._build_arrays(state.tables[sname],
                              state.table_opt[sname].acc)

  def apply_next(self, state):
    """Execute the oldest pending plan against the train state."""
    if not self._plans:
      return state
    import dataclasses
    from hybridbackend_tpu.embedding.sparse_update import SparseOptState
    plans = self._plans.popleft()
    tables = dict(state.tables)
    topt = dict(state.table_opt)
    for col, plan in plans.items():
      cache = self._caches[col]
      sname, off = self._loc[col]
      nslots = len(topt[sname].acc)
      arrays = cache.apply_plan(
          self._build_arrays(tables[sname], topt[sname].acc), plan,
          row_offset=off)
      tables[sname] = arrays['value']
      topt[sname] = SparseOptState(
          acc=tuple(arrays[f'slot{i}'] for i in range(nslots)))
    return dataclasses.replace(state, tables=tables, table_opt=topt)

  def drain(self, state):
    """Apply every pending plan. ONLY for loop exit (the producer has
    stopped and the drained batches will never train); mid-train use
    :meth:`checkpoint_flush` instead — draining a plan whose batch
    still trains would evict rows before their updates land."""
    while self._plans:
      state = self.apply_next(state)
    return state

  def flush(self, state) -> None:
    """Write all resident rows back. Requires a quiesced producer (loop
    exit, after :meth:`drain`); mid-train use :meth:`checkpoint_flush`."""
    for col, cache in self._caches.items():
      sname, off = self._loc[col]
      cache.flush(self._arrays_of(state, sname), row_offset=off)

  def checkpoint_flush(self, state) -> None:
    """Array-consistent flush while the prefetch producer keeps
    planning: atomically snapshot (pending plans, slot maps), UNDO the
    pending plans on the snapshot (they have advanced the metadata past
    the arrays), and write back rows under their true current owners.
    No plan is consumed — training continues exactly as before."""
    with self._runner_lock:
      pending = list(self._plans)
      snaps = {}
      for col, cache in self._caches.items():
        with cache._meta_lock:
          snaps[col] = cache._slot_to_id.copy()
    for col, cache in self._caches.items():
      s2id = snaps[col]
      for plans in reversed(pending):
        plan = plans.get(col)
        if plan is None:
          continue
        if plan.miss_slots.size:
          s2id[plan.miss_slots] = -1
        if plan.evict_slots.size:
          s2id[plan.evict_slots] = plan.evict_ids
      resident = np.nonzero(s2id >= 0)[0]
      if not resident.size:
        continue
      owners = s2id[resident]
      sname, off = self._loc[col]
      arrays = self._arrays_of(state, sname)
      idx = jnp.asarray(resident + off)
      for name, arr in arrays.items():
        rows = np.asarray(jnp.take(arr, idx, axis=0))
        cache.storage.push(name, owners, rows)


__all__ = ['EmbeddingCache', 'CachePlan', 'CacheRunner', 'Storage',
           'InMemoryStorage']
