"""Smoke test of the flagship sparse trainer on NVIDIA GPUs.

Usage (from the root of a checkout, on a machine with a GPU):

  python chip_smoke.py              # one card
  python chip_smoke.py --chips 4    # the row-sharded path on four cards

One card: the flagship stacked DCNv2 (26 tables of [100_000, 16] f32,
13 dense features, tower [1024, 512, 256, 1], global batch 8192,
Adagrad tables, Adam tower; ``hybridbackend_tpu/utils/flagship.py``)
trains 24 steps through ``hb.SparseTrainer`` and evaluates on held-out
batches. Its first three steps are compared with a plain float32
``jax.numpy`` reference, once with both sides under
``jax.default_matmul_precision('highest')`` and once with the program at
the default precision (TF32 matmuls on this card) against the same
exact reference. A control run with the program's matmuls at bf16 must
fail the default-precision bounds. The trainer is timed over the whole
window after warm-up, with no host sync in the timing hook; the same
jitted step is also timed on device-resident batches.

Four cards (``--chips 4``): only the multi-device path. The tables are
row-sharded over a (dcn=1, ici=4) mesh; the default allgather lookup
with the alltoall gradient return, and the alltoall lookup, are each
compared for three steps with the reference at 'highest' and timed at
the default precision.

Every phase must pass. The script exits non-zero, and prints no result
line, when JAX finds no GPU or any comparison fails. The last line of
standard output is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Bounds of the program against the plain reference, three steps from
# the same initial values and batches.
#
# 'highest': both sides compute in float32; only the order of sums
# differs (segment sums against the reference's dense scatter-add, and
# XLA's own reduction trees). Table values are about 0.25 in size (one
# ulp is 3e-8) and one step moves a touched row by 1e-5 to 1e-3, so
# 2e-6 is tens of ulps yet far below any single update; accumulators
# start at 0.1 (one ulp is 7e-9).
# 'default': the program's f32 matmuls run in TF32 (10-bit mantissa)
# while the reference stays exact; the loss and every gradient carry
# that error. On an H100 the TF32 run reads loss 2.1e-5, table rows
# 7.3e-6 and accumulators 7.0e-7; the same run with its matmuls at
# bf16 (the control at the end of the one-card phase) reads 1.9e-4,
# 1.1e-5 and 1.3e-6. The loss bound sits about 3x from each, so it
# fails bf16; the table and accumulator readings of the two lie too
# close together for a bound between them, so their bounds stand about
# 3x above TF32 and guard against gross errors only.
BOUNDS = {
    'highest': {'loss_rel': 1e-4, 'table_abs': 2e-6, 'acc_abs': 1e-6},
    'default': {'loss_rel': 6e-5, 'table_abs': 2e-5, 'acc_abs': 2e-6},
}
CHECK_TABLES = ('c0', 'c25')
COMPARE_STEPS = 3
TRAIN_STEPS = 24
WARMUP_STEPS = 4
EVAL_BATCHES = 4
FOUR_CARD_TIMED = 10
DEVICE_TIMED = 20


def say(key, value):
  print(f'{key}: {value}', flush=True)


class _CompileCounter:
  """Counts lowerings to XLA and sums compile-phase seconds."""

  EVENTS = ('/jax/core/compile/jaxpr_trace_duration',
            '/jax/core/compile/jaxpr_to_mlir_module_duration',
            '/jax/core/compile/backend_compile_duration')

  def __init__(self):
    import jax
    self.lowerings = 0
    self.seconds = 0.0
    jax.monitoring.register_event_duration_secs_listener(self._on)

  def _on(self, event, duration, **_):
    if event in self.EVENTS:
      self.seconds += duration
      if event == self.EVENTS[1]:
        self.lowerings += 1


def _trainer_hook(trainer, counter, snapshot_at=0, names=(), marks=()):
  """Hook that keeps each step's loss (on the device) and the compile
  count, and snapshots the state after step ``snapshot_at``. It waits
  for the device only after the steps in ``marks``, stamping the host
  clock there (``self.marks[n]``), so a window between two marks holds
  no host sync beyond the trainer's own."""
  import jax
  from hybridbackend_tpu.training.hooks import Hook
  from hybridbackend_tpu.utils.flagship import snapshot

  class _Hook(Hook):
    def __init__(self):
      self.losses, self.lowerings, self.marks = [], [], {}
      self.state_at = None

    def begin(self):
      self.t0 = time.perf_counter()

    def after_step(self, step, metrics):
      self.losses.append(metrics['loss'])
      self.lowerings.append(counter.lowerings)
      n = len(self.losses)
      if n == snapshot_at:
        self.state_at = snapshot(trainer, names)
      if n in marks:
        jax.block_until_ready(metrics['loss'])
        self.marks[n] = time.perf_counter()

    def loss_values(self):
      return [float(x) for x in self.losses]

  return _Hook()


def _window(label, hook, first, last, batch):
  """Steps ``first+1 .. last`` of a trainer run: mean ms per step and
  examples/s over the whole window; no compilation may fall in it."""
  secs = hook.marks[last] - hook.marks[first]
  n = last - first
  say(f'{label}trainer window', f'{n} steps in {secs * 1e3:.3f} ms')
  say(f'{label}trainer ms/step (window mean)', f'{secs / n * 1e3:.3f}')
  say(f'{label}trainer examples/s (window)', f'{batch * n / secs:.0f}')
  window = hook.lowerings[last - 1] - hook.lowerings[first - 1]
  say(f'{label}compilations in timed window', window)
  if window:
    raise AssertionError(f'{window} compilations inside the timed window')


def _device_step_ms(tr, batches, ctx, counter, label):
  """The trainer's jitted step alone, on device-resident batches: the
  device side of the step, without the host input pipeline."""
  import jax
  import numpy as np
  dev = [{k: jax.device_put(v, ctx.batch_sharding) for k, v in b.items()}
         for b in batches[:4]]
  for i in range(WARMUP_STEPS):
    tr.state, m = tr._step_fn(tr.state, dev[i % 4])
    jax.block_until_ready(m['loss'])
  before = counter.lowerings
  times = []
  for i in range(DEVICE_TIMED):
    t0 = time.perf_counter()
    tr.state, m = tr._step_fn(tr.state, dev[i % 4])
    jax.block_until_ready(m['loss'])
    times.append(time.perf_counter() - t0)
  t0 = time.perf_counter()
  for i in range(DEVICE_TIMED):
    tr.state, m = tr._step_fn(tr.state, dev[i % 4])
  jax.block_until_ready(m['loss'])
  window = time.perf_counter() - t0
  if counter.lowerings != before:
    raise AssertionError('compilations inside the device-step window')
  d = np.asarray(times) * 1e3
  say(f'{label}device-resident step ms median (sync each step)',
      f'{np.median(d):.3f}')
  say(f'{label}device-resident step ms all timed',
      ' '.join(f'{x:.3f}' for x in d))
  say(f'{label}device-resident ms/step (window mean, no per-step sync)',
      f'{window / DEVICE_TIMED * 1e3:.3f}')


def _report(label, dev, bounds):
  """Prints the deviations beside their bounds; returns those beyond."""
  for k, b in bounds.items():
    say(f'{label} {k}', f'{dev[k]:.3e} (bound {b:.0e})')
  say(f'{label} untouched_rows_moved', int(dev['untouched_moved']))
  return [k for k, b in bounds.items() if not dev[k] <= b]


def _check(label, dev, bounds):
  bad = _report(label, dev, bounds)
  if dev['untouched_moved']:
    bad.append('untouched_moved')
  if bad:
    raise AssertionError(f'{label}: program deviates from the reference '
                         f'beyond bounds in {bad}')


def _reference(init, batches, cfg):
  import jax
  from hybridbackend_tpu.utils.flagship import reference_steps
  with jax.default_matmul_precision('highest'):
    return reference_steps(init, batches, cfg)


def _compare(label, cfg, seed, ctx, batches, counter, precision, ref=None):
  """The program with its matmuls at ``precision`` against the exact
  reference, COMPARE_STEPS steps from the same initial values. Returns
  the deviations, the program's initial state and the reference run."""
  import jax
  from hybridbackend_tpu.utils.flagship import (
      build_trainer, compare, snapshot)
  with jax.default_matmul_precision(precision):
    tr = build_trainer(cfg, seed, ctx)
    init = snapshot(tr, cfg.table_names)
    hook = _trainer_hook(tr, counter, COMPARE_STEPS, CHECK_TABLES)
    tr.train(iter(batches[:COMPARE_STEPS]), hooks=[hook])
  if ref is None:
    ref = _reference(init, batches[:COMPARE_STEPS], cfg)
  ref_losses, ref_state = ref
  losses = hook.loss_values()
  say(f'{label} loss', ' '.join(f'{x:.6f}' for x in losses))
  say(f'{label} reference loss', ' '.join(f'{x:.6f}' for x in ref_losses))
  dev = compare(losses, hook.state_at, ref_losses, ref_state, init,
                batches[:COMPARE_STEPS])
  return dev, init, ref


def one_card(cfg, seed, ctx, counter):
  import jax
  import numpy as np
  from hybridbackend_tpu.utils.flagship import (
      build_trainer, compare, make_batches, snapshot)

  batches = make_batches(cfg, TRAIN_STEPS + EVAL_BATCHES, seed)
  train, held_out = batches[:TRAIN_STEPS], batches[TRAIN_STEPS:]

  # Training run at the default precision, through SparseTrainer.
  tr = build_trainer(cfg, seed, ctx)
  init = snapshot(tr, cfg.table_names)
  say('table layout', {n: tuple(t.shape) for n, t in tr.state.tables.items()})
  hook = _trainer_hook(tr, counter, COMPARE_STEPS, CHECK_TABLES,
                       marks=(1, WARMUP_STEPS, TRAIN_STEPS))
  compile_before = counter.seconds
  tr.train(iter(train), hooks=[hook])
  losses = hook.loss_values()
  say('train steps', len(losses))
  say('compile s (training run)', f'{counter.seconds - compile_before:.2f}')
  say('first step s (compile + run)', f'{hook.marks[1] - hook.t0:.2f}')
  _window('', hook, WARMUP_STEPS, TRAIN_STEPS, cfg.batch)
  say('loss trajectory', ' '.join(f'{x:.4f}' for x in losses))
  if not np.all(np.isfinite(losses)):
    raise AssertionError('non-finite training loss')
  stats = jax.local_devices()[0].memory_stats() or {}
  say('peak bytes in use', stats.get('peak_bytes_in_use'))
  res = tr.evaluate(iter(held_out))
  say('eval', res)
  if not (0.0 <= res['auc'] <= 1.0 and np.isfinite(res['loss'])
          and res['batches'] == EVAL_BATCHES):
    raise AssertionError(f'bad eval result {res}')
  _device_step_ms(tr, train, ctx, counter, '')
  tf32_state = hook.state_at
  tf32_losses = losses[:COMPARE_STEPS]
  del tr

  # The same three steps with both sides under 'highest'.
  dev, init_hi, ref = _compare('highest', cfg, seed, ctx, batches, counter,
                               'highest')
  for a, b in zip(jax.tree_util.tree_leaves(init['dense']),
                  jax.tree_util.tree_leaves(init_hi['dense'])):
    if not np.array_equal(a, b):
      raise AssertionError('two trainers from one seed start apart')
  _check('highest', dev, BOUNDS['highest'])
  # The default-precision run against the exact reference.
  ref_losses, ref_state = ref
  say('default loss', ' '.join(f'{x:.6f}' for x in tf32_losses))
  dev = compare(tf32_losses, tf32_state, ref_losses, ref_state, init,
                batches[:COMPARE_STEPS])
  _check('default', dev, BOUNDS['default'])
  # Control: the 'default' bounds must fail the program with its f32
  # matmuls taken at bfloat16, or they could not tell TF32 from it.
  dev, _, _ = _compare('bf16 control', cfg, seed, ctx, batches, counter,
                       'BF16_BF16_F32', ref)
  caught = _report('bf16 control', dev, BOUNDS['default'])
  say('bf16 control beyond the default bounds', caught)
  if not caught:
    raise AssertionError('the default bounds pass bf16 matmuls too')


def four_cards(cfg, seed, ctx, counter):
  from hybridbackend_tpu.framework.options import OPTIONS
  from hybridbackend_tpu.utils.flagship import build_trainer, make_batches

  n_steps = WARMUP_STEPS + FOUR_CARD_TIMED
  batches = make_batches(cfg, n_steps, seed)
  ref = None
  for strategy in ('allgather', 'alltoall'):
    label = f'4 cards, lookup {strategy}'
    with OPTIONS.override(emb_lookup_strategy=strategy,
                          emb_update_exchange='alltoall'):
      dev, _, ref = _compare(f'{label}, highest', cfg, seed, ctx, batches,
                             counter, 'highest', ref)
      _check(f'{label}, highest', dev, BOUNDS['highest'])
      tr = build_trainer(cfg, seed, ctx)
      say(f'{label} table layout',
          {n: (tuple(t.shape), len(t.sharding.device_set))
           for n, t in tr.state.tables.items()})
      hook = _trainer_hook(tr, counter, marks=(WARMUP_STEPS, n_steps))
      tr.train(iter(batches), hooks=[hook])
      _window(f'{label} ', hook, WARMUP_STEPS, n_steps, cfg.batch)
      _device_step_ms(tr, batches, ctx, counter, f'{label} ')
      del tr


def main():
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--chips', type=int, default=1, choices=(1, 4))
  p.add_argument('--seed', type=int, default=0)
  args = p.parse_args()

  sys.path.insert(0, HERE)
  import hybridbackend_tpu
  if os.path.dirname(os.path.dirname(os.path.abspath(
      hybridbackend_tpu.__file__))) != HERE:
    raise RuntimeError('hybridbackend_tpu was not found beside this '
                       'script; run it from a checkout of the repository')
  from hybridbackend_tpu.framework.platform import use_gpu
  devices = use_gpu()
  if len(devices) < args.chips:
    raise RuntimeError(f'--chips {args.chips} needs {args.chips} GPUs; '
                       f'JAX reports {len(devices)}')

  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True)
  for line in smi.stdout.strip().splitlines():
    say('nvidia-smi', line.strip())

  import jax
  import hybridbackend_tpu as hb
  from hybridbackend_tpu.utils.flagship import FlagshipConfig
  counter = _CompileCounter()
  ctx = hb.Context(hb.build_mesh(devices[:args.chips]))
  used = list(ctx.mesh.devices.flat)
  say('jax', f'{jax.__version__}, {used[0].platform}, '
      f'{used[0].device_kind}, {len(used)} used of {len(devices)} visible')
  say('mesh', dict(ctx.mesh.shape))
  cfg = FlagshipConfig()
  say('config', cfg)
  t0 = time.perf_counter()
  with hb.context_scope(ctx):
    if args.chips == 1:
      one_card(cfg, args.seed, ctx, counter)
    else:
      four_cards(cfg, args.seed, ctx, counter)
  say('wall s', f'{time.perf_counter() - t0:.1f}')
  print(json.dumps({'ok': True, 'device': {
      'platform': used[0].platform, 'kind': used[0].device_kind,
      'count': len(used)}}), flush=True)


if __name__ == '__main__':
  main()
