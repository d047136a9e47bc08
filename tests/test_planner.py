"""Tests for the cost-model sharding planner (AutoShard/RecShard-style
per-table decisions over the DictOption scopes; see PAPERS.md)."""

import numpy as np

import hybridbackend_tpu as hb
from hybridbackend_tpu.embedding import TableConfig
from hybridbackend_tpu.embedding.planner import (
    plan_scope_options, plan_sharding)


def test_small_hot_table_replicates_big_table_shards():
  cfgs = [TableConfig('tiny', 1000, 16),
          TableConfig('huge', 10_000_000, 16)]
  plans = plan_sharding(cfgs, {'tiny': 8192, 'huge': 8192})
  assert not plans['tiny'].sharded          # 64 KB table: replicate
  assert plans['huge'].sharded              # 640 MB table: shard


def test_hot_skewed_table_prefers_alltoall():
  cfgs = [TableConfig('hot', 10_000_000, 16)]
  # 65536 ids but only ~5% unique: deduplicated alltoall payload wins.
  # (At 8192 ids the allgather wins: the per-hop latency floor, taken
  # from NVLink's 450 GB/s, prices alltoall's extra hops above the
  # bytes it saves at that batch.)
  plans = plan_sharding(cfgs, {'hot': 65536}, unique_fraction={'hot': 0.05})
  assert plans['hot'].sharded
  assert plans['hot'].strategy == 'alltoall'
  assert plan_sharding(cfgs, {'hot': 8192}, unique_fraction={'hot': 0.05}
                       )['hot'].strategy == 'allgather'
  # Without dedup headroom the allgather exchange wins instead.
  plans2 = plan_sharding(cfgs, {'hot': 8192}, unique_fraction={'hot': 1.0})
  assert plans2['hot'].strategy in ('allgather', 'alltoall')


def test_budget_forces_sharding():
  cfgs = [TableConfig('a', 100_000, 64), TableConfig('b', 100_000, 64)]
  # Each table is 25.6 MB replicated; budget fits only one.
  plans = plan_sharding(cfgs, {'a': 4096, 'b': 4096},
                        hbm_budget_bytes=30_000_000)
  assert sum(not p.sharded for p in plans.values()) <= 1


def test_column_candidate_for_wide_dims():
  cfgs = [TableConfig('wide', 1_000_000, 512)]
  plans = plan_sharding(cfgs, {'wide': 1024}, column_min_dim=256)
  assert plans['wide'].sharded


def test_plan_applies_through_scopes():
  cfgs = [TableConfig('tiny2', 1000, 16),
          TableConfig('huge2', 10_000_000, 16)]
  plans = plan_sharding(cfgs, {'tiny2': 8192, 'huge2': 8192})
  with hb.scope(**plan_scope_options(plans)):
    assert cfgs[0].should_shard() == plans['tiny2'].sharded
    assert cfgs[1].should_shard() == plans['huge2'].sharded


def test_single_device_never_shards():
  from hybridbackend_tpu.framework.context import Context
  import jax
  from jax.sharding import Mesh
  mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('dcn', 'ici'))
  ctx = Context(mesh)
  plans = plan_sharding([TableConfig('x', 10_000_000, 16)], {'x': 8192},
                        ctx=ctx)
  assert not plans['x'].sharded


def test_multichip_plan_counts_physical_row_bytes():
  """Multi-chip plans must count the 128-lane tile tax for narrow
  tables: the 'auto' lane-pack policy packs only single-chip tables,
  so a [V, 16] table holds 512 B/row of HBM on an 8-device mesh, not
  64 B (r3 self-review: the budget check could admit an 8x-over-budget
  replicated plan)."""
  from hybridbackend_tpu.embedding.table import TableConfig

  cfg = TableConfig('n16', 100_000, 16)
  p = plan_sharding([cfg], {'n16': 8192})['n16']
  rows_held = 100_000 // 8 if p.sharded else 100_000
  assert p.hbm_bytes_per_device >= rows_held * 128 * 4

  # A config that FORCES packing stores at logical density.
  cfgp = TableConfig('p16', 100_000, 16, lane_pack=True)
  pp = plan_sharding([cfgp], {'p16': 8192})['p16']
  rows_held = 100_000 // 8 if pp.sharded else 100_000
  assert pp.hbm_bytes_per_device <= rows_held * 16 * 4
