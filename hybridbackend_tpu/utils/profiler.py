"""Profiling/tracing utilities.

Parity with the reference's NVTX profiler ranges
(``/root/reference/hybridbackend/common/profiler.h:28-41`` —
``ProfilerRange::forSynch/forLookup``) and graph dumps: ``jax.profiler``
traces capture the XLA timeline (viewable in TensorBoard/Perfetto) and
``named_scope`` annotates regions the way NVTX ranges do.
:func:`device_time_by_scope` reduces a trace to device time per named
scope and the device's idle share.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
from typing import Dict, Iterator, Optional, Sequence

import jax

from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('profile_dir', '', env='HB_PROFILE_DIR',
                 doc='Write jax.profiler traces here when set.')

# Reference: HB_UNOPTIMIZED/OPTIMIZED_GRAPH_PATH graph dumps. JAX
# equivalent: fn.lower(...).as_text() / .compile().as_text(); exposed
# here for discoverability.
def dump_hlo(jitted_fn, *example_args, optimized: bool = True) -> str:
  """Return the (optionally compiled/optimized) HLO of a jitted fn."""
  lowered = jitted_fn.lower(*example_args)
  if optimized:
    return lowered.compile().as_text()
  return lowered.as_text()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None) -> Iterator[None]:
  """Capture a device trace for the duration of the scope."""
  logdir = logdir or OPTIONS['profile_dir']
  if not logdir:
    yield
    return
  jax.profiler.start_trace(logdir)
  try:
    yield
  finally:
    jax.profiler.stop_trace()


named_scope = jax.named_scope  # NVTX-range analogue inside jit


_INSTR = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*metadata=\{[^}]*'
                    r'op_name="([^"]*)"')


def op_names(hlo_text: str) -> Dict[str, str]:
  """``{instruction name: op_name metadata}`` of a compiled HLO text."""
  out = {}
  for line in hlo_text.splitlines():
    m = _INSTR.match(line)
    if m:
      out[m.group(1)] = m.group(2)
  return out


def device_time_by_scope(trace_dir: str, hlo_text: str,
                         scopes: Sequence[str]) -> Dict[str, float]:
  """Device time of a traced window, in ns, split by ``named_scope``.

  Reads the newest ``.xplane.pb`` under ``trace_dir``. Every device
  event that names its HLO instruction (``hlo_op``) is attributed
  through the instruction's ``op_name`` (from ``hlo_text``, the
  compiled step's ``as_text()``) to the first of ``scopes`` it lies
  in, else to ``'other'``. Also returns ``'busy'`` (the union of the
  event intervals), ``'window'`` (first start to last end),
  ``'events'``, and ``'ops'``: ``{hlo_op: ns}`` for every instruction. Device planes are those named ``/device:...``; a trace
  with none (the CPU backend) falls back to every plane.
  """
  from jax.profiler import ProfileData
  files = sorted(glob.glob(os.path.join(trace_dir, '**', '*.xplane.pb'),
                           recursive=True), key=os.path.getmtime)
  if not files:
    raise FileNotFoundError(f'no .xplane.pb under {trace_dir}')
  planes = list(ProfileData.from_file(files[-1]).planes)
  device = [p for p in planes if p.name.startswith('/device:')]
  names = op_names(hlo_text)
  pats = [(s, re.compile(rf'(^|[/(]){re.escape(s)}([/)]|$)'))
          for s in scopes]
  out = {s: 0.0 for s in scopes}
  out['other'] = 0.0
  ops: Dict[str, float] = {}
  spans = []
  for plane in device or planes:
    for line in plane.lines:
      for ev in line.events:
        op = dict(ev.stats).get('hlo_op')
        if op is None:
          continue
        spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        path = names.get(op, '')
        scope = next((s for s, p in pats if p.search(path)), 'other')
        out[scope] += ev.duration_ns
        ops[op] = ops.get(op, 0.0) + ev.duration_ns
  spans.sort()
  busy, end = 0.0, None
  for a, b in spans:
    if end is None or a > end:
      busy += b - a
      end = b
    elif b > end:
      busy += b - end
      end = b
  out['busy'] = busy
  out['window'] = (max(b for _, b in spans) - spans[0][0]) if spans else 0.0
  out['events'] = float(len(spans))
  out['ops'] = ops
  return out
