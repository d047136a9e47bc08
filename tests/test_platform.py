"""Entry-point platform contract: a GPU or a failure, never a silent CPU
run; the compile cache's place; the package's import dependencies."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, cwd=REPO, timeout=300):
  env = dict(os.environ)
  env.pop('JAX_COMPILATION_CACHE_DIR', None)
  env.update(env_extra or {})
  args = (code_or_args if isinstance(code_or_args, list)
          else [sys.executable, '-c', code_or_args])
  return subprocess.run(args, capture_output=True, text=True, cwd=cwd,
                        env=env, timeout=timeout)


def _no_result_line(out):
  lines = out.strip().splitlines()
  if not lines:
    return True
  try:
    return 'ok' not in json.loads(lines[-1])
  except ValueError:
    return True


def test_use_gpu_refuses_the_cpu():
  code = ('from hybridbackend_tpu.framework.platform import use_gpu\n'
          'try:\n'
          '  use_gpu()\n'
          'except RuntimeError as e:\n'
          '  print(e)\n')
  p = _run(code, {'JAX_PLATFORMS': 'cpu'})
  assert p.returncode == 0, p.stderr
  assert p.stdout.startswith('no GPU backend'), p.stdout


def test_chip_smoke_fails_without_a_gpu():
  p = _run([sys.executable, 'chip_smoke.py'], {'JAX_PLATFORMS': 'cpu'})
  assert p.returncode != 0
  assert 'no GPU' in p.stderr
  assert _no_result_line(p.stdout), p.stdout


def test_chip_smoke_fails_alone(tmp_path):
  """Copied out of the checkout, the script must not find the program
  (nor one installed elsewhere) and must print no result."""
  shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
  p = _run([sys.executable, 'chip_smoke.py'], {'JAX_PLATFORMS': 'cpu'},
           cwd=str(tmp_path))
  assert p.returncode != 0
  assert _no_result_line(p.stdout), p.stdout


def test_compile_cache_goes_to_the_checkout_by_default():
  code = ('import jax\n'
          'from hybridbackend_tpu.framework.platform import '
          'place_compile_cache, CACHE_DIR\n'
          'print(place_compile_cache())\n'
          'print(jax.config.jax_compilation_cache_dir)\n'
          'print(CACHE_DIR)\n')
  p = _run(code, {'JAX_PLATFORMS': 'cpu'})
  assert p.returncode == 0, p.stderr
  placed, configured, const = p.stdout.strip().splitlines()
  assert placed == configured == const == os.path.join(REPO, '.jax_cache')


def test_compile_cache_follows_the_environment(tmp_path):
  """With JAX_COMPILATION_CACHE_DIR set, the code sets nothing and the
  compiled program lands in that directory."""
  cache = tmp_path / 'cache'
  code = ('import jax, jax.numpy as jnp\n'
          'jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)\n'
          'jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)\n'
          'from hybridbackend_tpu.framework.platform import '
          'place_compile_cache\n'
          'print(place_compile_cache())\n'
          'print(jax.config.jax_compilation_cache_dir)\n'
          'jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n')
  p = _run(code, {'JAX_PLATFORMS': 'cpu',
                  'JAX_COMPILATION_CACHE_DIR': str(cache)})
  assert p.returncode == 0, p.stderr
  placed, configured = p.stdout.strip().splitlines()
  assert placed == configured == str(cache)
  assert cache.is_dir() and any(cache.iterdir())
  assert not os.path.exists(os.path.join(str(tmp_path), '.jax_cache'))


def test_package_imports_without_optional_packages():
  code = ('import sys\n'
          'for m in ("orbax", "pyarrow", "pandas", "flax"):\n'
          '  sys.modules[m] = None\n'
          'import hybridbackend_tpu as hb\n'
          'import hybridbackend_tpu.utils.flagship\n'
          'assert hb.SparseTrainer and hb.training.CheckpointManager\n'
          'print("imported")\n')
  p = _run(code, {'JAX_PLATFORMS': 'cpu'})
  assert p.returncode == 0, p.stderr
  assert p.stdout.strip() == 'imported'
