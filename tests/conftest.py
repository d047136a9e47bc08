"""Test fixture: run every test on a virtual 8-device CPU mesh.

Mirrors the reference's ``Spawn`` multi-process fixture
(``/root/reference/hybridbackend/common/test.py:36-152``), which forks N
processes with one GPU each to test collectives. In JAX the same
coverage comes from ``--xla_force_host_platform_device_count``: a single
process with N virtual CPU devices exercising the identical ``Mesh`` /
``shard_map`` / collective code paths as a multi-GPU mesh.

``JAX_PLATFORMS`` picks the platform (``cpu`` unless set); the tests
marked ``gpu`` need ``JAX_PLATFORMS=cuda`` and a card.
"""

import os

os.environ.setdefault('XLA_FLAGS', '--xla_force_host_platform_device_count=8')
if '--xla_force_host_platform_device_count' not in os.environ['XLA_FLAGS']:
  os.environ['XLA_FLAGS'] += ' --xla_force_host_platform_device_count=8'

import jax  # noqa: E402

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_context():
  """Fresh default Context per test (mesh over all 8 CPU devices)."""
  from hybridbackend_tpu.framework.context import Context
  Context.reset()
  yield
  Context.reset()
