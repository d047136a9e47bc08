"""Platform selection: the GPU for entry points, virtual CPUs for tests.

:func:`use_gpu` is what every entry point that measures or trains on the
card calls first: it places JAX's persistent compile cache and demands a
GPU backend, failing instead of falling back to the CPU.
:func:`force_host_devices` gives tests, dry runs and the launcher's
``--simulate`` mode a CPU platform with ``n`` virtual devices.
"""

from __future__ import annotations

import os
from typing import List

# The checkout root: two levels above this package's ``framework/``.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(CHECKOUT, '.jax_cache')


def place_compile_cache() -> str:
  """Point JAX's persistent compile cache at a fixed directory.

  ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
  left alone. Otherwise the cache goes to ``<checkout>/.jax_cache``: the
  path is part of the cache key, so it never depends on a temporary
  name, a pid or the time. Returns the directory in use.
  """
  import jax
  env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
  if env:
    return env
  jax.config.update('jax_compilation_cache_dir', CACHE_DIR)
  return CACHE_DIR


def use_gpu() -> List['jax.Device']:
  """Place the compile cache and return the GPU devices.

  Raises ``RuntimeError`` when JAX finds no GPU: a measurement or a
  training run on the CPU would be reported as if it had run on the card.
  """
  place_compile_cache()
  import jax
  try:
    devices = jax.devices('gpu')
  except RuntimeError as e:
    raise RuntimeError(f'no GPU backend: {e}') from e
  if not devices:
    raise RuntimeError('no GPU backend: JAX reports no GPU devices')
  return devices


def force_host_devices(n: int) -> None:
  """Force the CPU platform with ``n`` virtual devices.

  Must run before any backend-initializing JAX call; silently keeps the
  current backend if one is already initialized.
  """
  flags = os.environ.get('XLA_FLAGS', '')
  if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + f' --xla_force_host_platform_device_count={n}').strip()
  os.environ.setdefault('JAX_PLATFORMS', 'cpu')
  import jax
  try:
    jax.config.update('jax_platforms', 'cpu')
  except RuntimeError:
    pass  # backend already initialized


__all__ = ['CACHE_DIR', 'force_host_devices', 'place_compile_cache',
           'use_gpu']
