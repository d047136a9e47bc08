"""Cost-model sharding planner for embedding tables.

The reference shards every table above a size threshold
(``/root/reference/hybridbackend/tensorflow/embedding/sharding.py:67-75``);
research systems (AutoShard, RecShard, DreamShard — see PAPERS.md) show
per-table *cost-model* decisions beat one threshold. This module is
an analytic per-table model of bytes moved per step and
HBM held per device for each placement, returning a plan that routes
through the per-table DictOption scopes
(:meth:`hybridbackend_tpu.framework.options.Options.get_for`).

Model (per table, per step, float32 elements; ``W`` world size, ``B``
global flat ids per step, ``D`` dim, ``V`` vocab, ``u`` expected unique
fraction of ``B``, ring factor ``f = (W-1)/W``, bucket slack ``s`` =
``emb_lookup_bucket_ratio``/``emb_update_bucket_ratio``). Byte formulas
are CALIBRATED against compiled-HLO collective counts
(:mod:`hybridbackend_tpu.utils.hlo_bytes`;
``tests/test_planner_calibration.py`` enforces agreement within a small
factor):

* replicated — HBM ``V*D*4`` on EVERY device; forward free; backward
  all-gathers the global (rows, grads) payload ``f*B*(D+1)*4`` per
  device on the sparse path, or all-reduces the dense [V, D] gradient
  ``2*f*V*D*4`` on the dense-param path (the model takes the min).
* row-sharded, allgather exchange — HBM ``V*D*4/W``; forward
  all-gathers ids ``f*B*4`` and returns embeddings via reduce-scatter
  ``f*B*D*4``; backward all-gathers the cotangent ``f*B*D*4``; plus the
  ONE-way bucketed update exchange ``f*s*(B/W)*(D+1)*4``. Linear in
  the GLOBAL batch — W-independent per device.
* row-sharded, alltoall exchange — static buckets of ``s*B/W`` rows per
  device: ids out + embeddings back + cotangent back + one-way update
  = ``f*s*(B/W)*(3D+2)*4`` total — a ~``W/s`` wire win over allgather
  (the reference alltoallv's whole point,
  ``nccl_alltoallv.cc:200-350``). The hierarchical two-hop form moves
  the SAME per-device bytes (HLO-measured); its win is that hop-0
  stays inside a host.
* column-sharded — HBM ``V*D*4/W``; forward ``f*B*4`` ids +
  ``f*B*D*4`` embedding alltoall; sensible for very large ``D``
  where per-row slices still fill lanes.

The latency floor ``HOP`` cannot be calibrated on a CPU mesh. It is an
assumption from the H100 data sheet, not a measurement: ~1 us per
collective hop at NVLink's 450 GB/s each way ≈ 450 KB of
bytes-equivalent per collective.

The plan is a *starting point* measured in bytes — profile and override
(every knob remains a scoped option).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

from hybridbackend_tpu.framework.context import Context


@dataclasses.dataclass(frozen=True)
class TablePlan:
  """Chosen placement for one table (all fields map to options)."""
  sharded: bool
  partition: str          # 'row' | 'column'
  strategy: str           # lookup strategy when sharded
  hbm_bytes_per_device: int
  comm_bytes_per_step: int


def _ring(w):
  return (w - 1) / max(w, 1)


def _phys_row_bytes(d: int, packed: bool = False) -> int:
  """PHYSICAL bytes per table row: XLA tiles f32 minor dims to 128
  lanes, so an unpacked narrow row occupies ceil(d/128)*128 floats.
  Lane-packed tables (``emb_lane_pack``, 128 % d == 0) store at
  logical density — but the 'auto' policy packs only single-chip
  tables, so multi-chip plans must assume ``packed`` only when the
  config forces ``lane_pack=True``."""
  if packed and d < 128 and 128 % d == 0:
    return d * 4            # lane-packed -> logical density
  return ((d + 127) // 128) * 128 * 4


def _cost_replicated(v, d, b, w=1, packed=False, backward='auto'):
  """``backward``: 'sparse' = the sparse-update path's (ids, grads)
  all-gather (what ``sparse_*_apply`` ALWAYS emits for replicated
  tables — bytes ∝ the global batch); 'dense' = the dense-param path's
  [V, D] gradient all-reduce (what ``make_train_step`` emits when the
  table lives in params); 'auto' = min of both, the planner's
  assumption that the caller picks the cheaper formulation. The
  calibration test pins 'sparse' against compiled HLO exactly
  (tests/test_planner_calibration.py)."""
  f = _ring(w)
  sparse_bwd = f * b * (d + 1) * 4      # ids all-gather + grads all-gather
  dense_bwd = 2 * f * v * d * 4         # ring all-reduce of [V, D]
  comm = {'sparse': sparse_bwd, 'dense': dense_bwd,
          'auto': min(sparse_bwd, dense_bwd)}[backward]
  return v * _phys_row_bytes(d, packed), int(comm)


# NOTE on the unique fraction ``u``: bucket capacities are STATIC
# (``cap = slack·ceil(b_local/W)``), so compiled-HLO wire bytes do not
# depend on realized uniqueness — ``u`` is accepted for API parity but
# no longer scales the bucketed terms (round-4 calibration: the old
# ``u``-scaled formulas drifted 1.5–2x from HLO; the static forms below
# match it to <0.1%).


def _cost_row_allgather(v, d, b, w, u, slack, packed=False):
  del u   # static buckets (see note above)
  f = _ring(w)
  fwd = f * (b * 4 + b * d * 4)        # ids all-gather + reduce-scatter
  bwd = f * b * d * 4                  # cotangent all-gather
  # Gradient-return exchange is ONE-way (ids + per-row totals to the
  # owner; nothing comes back): f·W·cap·(D+1)·4 per device.
  upd = f * slack * (b / max(w, 1)) * (d + 1) * 4
  return v * _phys_row_bytes(d, packed) // w, int(fwd + bwd + upd)


def _cost_row_alltoall(v, d, b, w, u, slack, packed=False):
  del u   # static buckets (see note above)
  f = _ring(w)
  bucket_rows = max(1.0, slack * b / max(w, 1))   # W·cap rows per device
  fwd = f * bucket_rows * (4 + d * 4)   # ids out + embeddings back
  bwd = f * bucket_rows * d * 4         # cotangent reverse alltoall
  upd = f * bucket_rows * (d + 1) * 4   # grad-return (ids + totals)
  return v * _phys_row_bytes(d, packed) // w, int(fwd + bwd + upd)


def _cost_row_hierarchical(v, d, b, w, u, slack, packed=False):
  """Two-hop (ICI-then-DCN) exchange. Per-DEVICE wire bytes equal the
  flat alltoall's (HLO-measured identical — each hop's bucket capacity
  shrinks by the hop's axis size, and the two hops compose back to the
  flat volume); the strategy's win is WHERE the bytes ride (hop-0 stays
  on ICI), which a single byte number cannot express — the planner
  therefore never prefers it on bytes; it is a topology choice."""
  return _cost_row_alltoall(v, d, b, w, u, slack, packed)


def _cost_column(v, d, b, w, packed=False):
  f = _ring(w)
  fwd = f * (b * 4 + b * d * 4)
  return v * _phys_row_bytes(d, packed) // w, int(2 * fwd)


def plan_sharding(configs: Sequence,
                  global_batch_ids: Mapping[str, int],
                  unique_fraction: Optional[Mapping[str, float]] = None,
                  hbm_budget_bytes: Optional[int] = None,
                  bucket_slack: float = 2.0,
                  column_min_dim: int = 256,
                  ctx: Optional[Context] = None
                  ) -> Dict[str, TablePlan]:
  """Pick a placement per table by analytic cost.

  Args:
    configs: ``TableConfig``s (only ``name``/``vocab_size``/``dim``
      read).
    global_batch_ids: per-table flat ids per global step (e.g.
      ``batch * avg_multivalence``).
    unique_fraction: per-table expected unique-id fraction of the
      global batch (measure it: ``len(np.unique(ids)) / len(ids)``);
      default 1.0 (no dedup win assumed).
    hbm_budget_bytes: per-device budget for REPLICATED tables — a
      replicated choice that would exceed the remaining budget is
      forced to shard (RecShard-style capacity constraint).
    bucket_slack: alltoall bucket capacity slack (matches
      ``emb_update_bucket_ratio``).
    column_min_dim: consider column sharding only at/above this dim
      (below it, per-device row slices are too narrow to pay).

  Returns ``{table_name: TablePlan}``; apply with
  :func:`plan_scope_options`.
  """
  ctx = ctx or Context.get()
  w = ctx.world_size
  uniq = dict(unique_fraction or {})
  plans: Dict[str, TablePlan] = {}
  replicated_budget = hbm_budget_bytes
  # Each collective hop pays a latency floor independent of payload —
  # modeled as bytes-equivalent. Data-sheet assumption, not measured:
  # ~1 us per hop at the H100's NVLink rate of 450 GB/s each way
  # ≈ 450 KB. Replication's local gather has one backward collective;
  # the exchanges pay 3-6 hops.
  HOP = 450_000
  # A byte HELD costs a small fraction of a byte MOVED per step:
  # keeps replication from winning on comm alone for giant tables even
  # without an explicit budget.
  MEM_W = 0.01
  # Small tables first so the replication budget goes to the tables
  # that benefit most per byte (small hot tables).
  order = sorted(configs, key=lambda c: c.vocab_size * c.dim)
  for cfg in order:
    v, d = cfg.vocab_size, cfg.dim
    b = int(global_batch_ids.get(cfg.name, 0)) or 1
    u = float(uniq.get(cfg.name, 1.0))
    # Ask the REAL packing policy (config field + emb_lane_pack option
    # + world size) whether this table stores lane-packed — hand-rolled
    # predicates here drifted from it once already.
    pf = getattr(cfg, 'pack_factor', None)
    if callable(pf):
      packed = pf(ctx) > 1
    else:   # plain duck-typed config in tests
      packed = getattr(cfg, 'lane_pack', None) is True or w <= 1
    if w <= 1:
      plans[cfg.name] = TablePlan(False, 'row', 'allgather',
                                  v * _phys_row_bytes(d, packed), 0)
      continue
    candidates = {}
    mem, comm = _cost_replicated(v, d, b, w, packed)
    over_budget = (replicated_budget is not None
                   and mem > replicated_budget)
    if not over_budget:
      candidates[('replicated', 'row', 'allgather')] = (
          mem, comm + 1 * HOP)
    mem, comm = _cost_row_allgather(v, d, b, w, u, bucket_slack, packed)
    candidates[('sharded', 'row', 'allgather')] = (mem, comm + 4 * HOP)
    # alltoallv = sizes + ids + sizes + payload each way ≈ 8 launches.
    mem, comm = _cost_row_alltoall(v, d, b, w, u, bucket_slack, packed)
    candidates[('sharded', 'row', 'alltoall')] = (mem, comm + 8 * HOP)
    if d >= column_min_dim:
      mem, comm = _cost_column(v, d, b, w, packed)
      candidates[('sharded', 'column', 'allgather')] = (
          mem, comm + 3 * HOP)
    (kind, part, strat), (mem, comm) = min(
        candidates.items(), key=lambda kv: kv[1][1] + MEM_W * kv[1][0])
    if kind == 'replicated' and replicated_budget is not None:
      replicated_budget -= mem
    plans[cfg.name] = TablePlan(kind == 'sharded', part, strat, mem,
                                comm)
  return plans


def plan_scope_options(plans: Mapping[str, TablePlan]) -> Dict[str, Dict]:
  """Convert a plan into per-table DictOption scopes::

      with hb.scope(**plan_scope_options(plans)):
          fx = StackedFeatureExtractor(specs, ...)   # resolve at build
          ...

  Only ``emb_sharded`` and ``emb_lookup_strategy`` are scoped; column
  partitioning is a ``TableConfig(partition='column')`` property — the
  plan reports it so callers can set it on the config.
  """
  return {
      'emb_sharded': {name: p.sharded for name, p in plans.items()},
      'emb_lookup_strategy': {name: p.strategy
                              for name, p in plans.items()},
  }


__all__ = ['TablePlan', 'plan_sharding', 'plan_scope_options']
