"""Embedding lookup benchmark: strategy sweep.

Port of ``/root/reference/hybridbackend/tensorflow/benchmarks/
embedding_benchmark_tier1.py`` + ``partition_by_modulo_benchmark.py``:
times sharded lookup (fwd and fwd+bwd) per strategy and the partition
primitive.

Usage: python benchmarks/embedding_benchmark.py [--vocab 1000000]
       [--dim 64] [--batch 8192] [--steps 20] [--cpu N]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import time


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--vocab', type=int, default=1_000_000)
  p.add_argument('--dim', type=int, default=64)
  p.add_argument('--batch', type=int, default=8192)
  p.add_argument('--steps', type=int, default=20)
  p.add_argument('--cpu', type=int, default=0)
  args = p.parse_args()

  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import jax
  import jax.numpy as jnp
  import numpy as np
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.distribute.partition import partition_by_modulo
  from hybridbackend_tpu.embedding import TableConfig, create_table, lookup

  ctx = hb.Context.get()
  world = ctx.world_size
  cfg = TableConfig('bench', args.vocab, args.dim)
  table = create_table(cfg, jax.random.PRNGKey(0))
  ids = jax.device_put(
      jnp.asarray(np.random.RandomState(0).randint(
          0, args.vocab, args.batch), jnp.int32), ctx.batch_sharding)
  strategies = ['allgather', 'alltoall', 'gspmd']
  if len(ctx.mesh.axis_names) == 2 and world > 1:
    strategies.append('hierarchical')
  if world == 1:
    strategies = ['gspmd']
  bytes_moved = args.batch * args.dim * 4

  print(f'devices={world} vocab={args.vocab} dim={args.dim} '
        f'batch={args.batch}')
  print(f'{"Strategy":<14}{"Mode":<10}{"ms":<10}{"GB/s":<10}')
  for strategy in strategies:
    fwd = jax.jit(lambda t, i, s=strategy: lookup(t, i, cfg, strategy=s))
    bwd = jax.jit(jax.grad(
        lambda t, i, s=strategy: jnp.sum(lookup(t, i, cfg, strategy=s))))
    for mode, fn in (('fwd', fwd), ('fwd+bwd', bwd)):
      fn(table, ids).block_until_ready()
      t0 = time.perf_counter()
      for _ in range(args.steps):
        r = fn(table, ids)
      r.block_until_ready()
      dt = (time.perf_counter() - t0) / args.steps
      print(f'{strategy:<14}{mode:<10}{dt * 1e3:<10.3f}'
            f'{bytes_moved / dt / 1e9:<10.2f}')

  part = jax.jit(lambda i: partition_by_modulo(i, world))
  part(ids).buckets.block_until_ready()
  t0 = time.perf_counter()
  for _ in range(args.steps):
    r = part(ids)
  r.buckets.block_until_ready()
  dt = (time.perf_counter() - t0) / args.steps
  print(f'{"partition":<14}{"fwd":<10}{dt * 1e3:<10.3f}'
        f'{args.batch / dt / 1e6:.1f} Mids/s')


if __name__ == '__main__':
  main()
