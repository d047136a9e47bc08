"""Collective wire-byte accounting from compiled HLO.

The reference publishes measured collective tables
(the reference's ``docs/data.md:265-285``); under XLA the compiler decides
the final collectives, so the ground truth is the compiled HLO. This
module counts, per device, the bytes each collective op moves on the
interconnect under standard ring/all-pairs algorithms:

All formulas are in terms of the op's RESULT size ``S`` as printed in
the (post-SPMD, per-device-local-shape) compiled module:

* ``all-gather``      (result ``S = W·chunk``): sends ``S·(W-1)/W``
* ``reduce-scatter``  (result ``S = chunk``):   sends ``S·(W-1)``
* ``all-to-all``      (result ``S``):           sends ``S·(W-1)/W``
* ``all-reduce``      (result ``S``):           sends ``2·S·(W-1)/W``
* ``collective-permute`` (result ``S``):        sends ``S``

Used to verify strategy wire-volume claims and to calibrate/test the
sharding planner's byte model against what XLA actually emits.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

_DTYPE_BYTES = {
    'f64': 8, 'f32': 4, 'bf16': 2, 'f16': 2, 'f8e4m3': 1, 'f8e5m2': 1,
    's64': 8, 'u64': 8, 's32': 4, 'u32': 4, 's16': 2, 'u16': 2,
    's8': 1, 'u8': 1, 'pred': 1,
}

_COLLECTIVES = ('all-gather', 'all-to-all', 'reduce-scatter',
                'all-reduce', 'collective-permute')

_SHAPE_RE = re.compile(r'(\w+)\[([0-9,]*)\]')
# The op application: " all-to-all(" / " all-reduce-start(" etc.
_CALL_RE = re.compile(
    r'\s(all-gather|all-to-all|reduce-scatter|all-reduce|'
    r'collective-permute)(?:-start)?\(')


def _nbytes(dtype: str, dims: str) -> int:
  n = _DTYPE_BYTES.get(dtype, 4)
  for d in dims.split(','):
    if d:
      n *= int(d)
  return n


def collective_bytes(hlo_text: str, world: int
                     ) -> Tuple[int, Dict[str, int]]:
  """Per-device wire bytes of every collective in compiled HLO text.

  Returns ``(total_bytes, {op_kind: bytes})``. ``world`` is the number
  of participating devices (ring factor ``(W-1)/W``).
  """
  per_kind: Dict[str, int] = {}
  f = (world - 1) / max(world, 1)
  for line in hlo_text.splitlines():
    if not any(c in line for c in _COLLECTIVES):
      continue
    if '-done' in line or 'get-tuple-element' in line:
      continue
    eq = line.find(' = ')
    if eq < 0:
      continue
    m = _CALL_RE.search(line, eq)
    if not m:
      continue
    kind = m.group(1)
    # Result region between '=' and the op application; a variadic op
    # prints a tuple of per-peer shapes (with /*index=N*/ comments) —
    # sum every shape in it.
    shapes = _SHAPE_RE.findall(line[eq + 3:m.start()])
    size = sum(_nbytes(dt, dims) for dt, dims in shapes)
    if kind == 'all-reduce':
      wire = int(2 * size * f)
    elif kind == 'collective-permute':
      wire = size
    elif kind == 'reduce-scatter':
      # Result is the post-scatter chunk; each device contributed W
      # chunks and ships W-1 of them.
      wire = int(size * (world - 1))
    else:
      wire = int(size * f)
    per_kind[kind] = per_kind.get(kind, 0) + wire
  return sum(per_kind.values()), per_kind


def lowered_collective_bytes(jitted_lowered_compiled_text: str,
                             world: int) -> Tuple[int, Dict[str, int]]:
  """Alias with an explicit name for call sites."""
  return collective_bytes(jitted_lowered_compiled_text, world)


__all__ = ['collective_bytes', 'lowered_collective_bytes']
