"""Collective benchmark: allreduce/alltoall sweep by message size.

Port of ``/root/reference/hybridbackend/tensorflow/benchmarks/
collective_benchmark.py`` (prints Rank/Collective/Topology/Device/Size/
Throughput table, ``collective_benchmark.py:150-164``) to the JAX device
mesh.

Usage: python benchmarks/collective_benchmark.py [--sizes-mb 1 4 16 64]
       [--collectives allreduce alltoall allgather] [--steps 20] [--cpu N]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import time

import numpy as np


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--sizes-mb', type=float, nargs='+',
                 default=[1, 4, 16, 64])
  p.add_argument('--collectives', nargs='+',
                 default=['allreduce', 'alltoall', 'allgather',
                          'reducescatter'])
  p.add_argument('--steps', type=int, default=20)
  p.add_argument('--cpu', type=int, default=0,
                 help='simulate N CPU devices instead of the GPUs')
  args = p.parse_args()

  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import jax
  import jax.numpy as jnp
  from jax.sharding import PartitionSpec as P
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.distribute import (
      all_gather_t, all_to_all_t, psum_scatter_t, psum_t)

  ctx = hb.Context.get()
  axes = ctx.data_axes
  world = ctx.world_size
  print(f'devices={world} mesh={dict(ctx.mesh.shape)}')
  print(f'{"Collective":<14}{"Size(MB)":<10}{"ms":<10}{"GB/s(algo)":<12}')

  ops = {
      'allreduce': lambda x: psum_t(x, axes),
      'alltoall': lambda x: all_to_all_t(x, axes, 0, 0, tiled=True),
      'allgather': lambda x: all_gather_t(x, axes, 0, tiled=True),
      'reducescatter': lambda x: psum_scatter_t(x, axes, 0, tiled=True),
  }
  for size_mb in args.sizes_mb:
    n = int(size_mb * 1e6 / 4)
    n = (n // (world * 128)) * world * 128
    x = jnp.ones((n,), jnp.float32)
    for name in args.collectives:
      fn = jax.jit(jax.shard_map(
          ops[name], mesh=ctx.mesh, in_specs=P(axes), out_specs=(
              P(axes) if name in ('alltoall', 'reducescatter') else P()),
          check_vma=False))
      fn(x).block_until_ready()
      t0 = time.perf_counter()
      for _ in range(args.steps):
        r = fn(x)
      r.block_until_ready()
      dt = (time.perf_counter() - t0) / args.steps
      gbps = n * 4 / dt / 1e9
      print(f'{name:<14}{size_mb:<10}{dt * 1e3:<10.3f}{gbps:<12.2f}')


if __name__ == '__main__':
  main()
