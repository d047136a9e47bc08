"""Typed, env-overridable configuration registry.

A JAX re-design of the reference's ``Options`` registry
(``/root/reference/hybridbackend/tensorflow/framework/options.py:29-257``):
every knob is registered with a name, a default, an optional environment
variable that overrides the default at first read, and an optional parser.
Scoped overrides are provided by :meth:`Options.override`, which is how
``hb.scope(**kwargs)`` semantics are expressed in a functional framework —
no monkey patching, just a context manager pushing values onto a stack.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Dict, Iterator, Optional


def _parse_bool(value: str) -> bool:
  return value.strip().lower() in ('1', 'true', 'yes', 'on')


def _default_parser_for(default: Any) -> Callable[[str], Any]:
  if isinstance(default, bool):
    return _parse_bool
  if isinstance(default, int):
    return int
  if isinstance(default, float):
    return float
  return str


class Option:
  """A single registered option."""

  __slots__ = ('name', 'default', 'env', 'parser', 'doc')

  def __init__(self, name: str, default: Any,
               env: Optional[str] = None,
               parser: Optional[Callable[[str], Any]] = None,
               doc: str = ''):
    self.name = name
    self.default = default
    self.env = env
    self.parser = parser or _default_parser_for(default)
    self.doc = doc

  def resolve_default(self) -> Any:
    if self.env is not None:
      raw = os.environ.get(self.env)
      if raw is not None:
        return self.parser(raw)
    return self.default


class Options:
  """Thread-safe registry of named options with scoped overrides.

  Mirrors the capability surface of the reference options registry
  (register defaults, env var override, per-scope values) in an explicit,
  functional style. Values resolve in priority order:

  1. innermost active :meth:`override` scope,
  2. explicit :meth:`set` value,
  3. environment variable (if registered with ``env=``),
  4. registered default.
  """

  def __init__(self):
    self._options: Dict[str, Option] = {}
    self._values: Dict[str, Any] = {}
    self._local = threading.local()
    self._lock = threading.RLock()

  def _stack(self):
    if not hasattr(self._local, 'stack'):
      self._local.stack = []
    return self._local.stack

  def register(self, name: str, default: Any,
               env: Optional[str] = None,
               parser: Optional[Callable[[str], Any]] = None,
               doc: str = '') -> None:
    with self._lock:
      if name in self._options:
        return
      self._options[name] = Option(name, default, env=env, parser=parser,
                                   doc=doc)

  def registered(self, name: str) -> bool:
    return name in self._options

  def get(self, name: str) -> Any:
    if name not in self._options:
      raise KeyError(f'Unknown option: {name!r}')
    for frame in reversed(self._stack()):
      if name in frame:
        return frame[name]
    with self._lock:
      if name in self._values:
        return self._values[name]
    return self._options[name].resolve_default()

  def __getitem__(self, name: str) -> Any:
    return self.get(name)

  def get_for(self, name: str, key: str) -> Any:
    """Per-key resolution of a dict-valued option (the reference's
    ``DictOption`` with ``'*'`` wildcard, ``options.py:183-225``).

    A scope may set an option to ``{'user_id': 'alltoall',
    '*': 'allgather'}``; ``get_for('emb_lookup_strategy', 'user_id')``
    returns the per-key value, any other key gets the wildcard, and a
    dict without a wildcard falls back to the registered default.
    Scalar values resolve as usual.
    """
    v = self.get(name)
    if isinstance(v, dict):
      if key in v:
        return v[key]
      if '*' in v:
        return v['*']
      return self._options[name].resolve_default()
    return v

  def set(self, name: str, value: Any) -> None:
    if name not in self._options:
      raise KeyError(f'Unknown option: {name!r}')
    with self._lock:
      self._values[name] = value

  def __setitem__(self, name: str, value: Any) -> None:
    self.set(name, value)

  @contextlib.contextmanager
  def override(self, **kwargs: Any) -> Iterator['Options']:
    """Scoped option overrides: ``with options.override(batch_size=8):``."""
    for name in kwargs:
      if name not in self._options:
        raise KeyError(f'Unknown option: {name!r}')
    self._stack().append(dict(kwargs))
    try:
      yield self
    finally:
      self._stack().pop()

  def to_dict(self) -> Dict[str, Any]:
    return {name: self.get(name) for name in self._options}

  def describe(self) -> str:
    lines = []
    for name, opt in sorted(self._options.items()):
      env = f' (env {opt.env})' if opt.env else ''
      lines.append(f'{name} = {self.get(name)!r}{env}  # {opt.doc}')
    return '\n'.join(lines)


# The global options registry. Subsystems register their knobs at import
# time; see each package's __init__ for its registrations.
OPTIONS = Options()

# Core knobs (reference: framework/options.py + training/__init__.py:47-58).
OPTIONS.register('seed', None, env='HB_SEED',
                 parser=int, doc='Deterministic seed for all RNG streams.')
OPTIONS.register('mode', 'train', env='HB_MODE',
                 doc='One of train/eval/predict.')
OPTIONS.register('batch_size', -1, env='HB_BATCH_SIZE',
                 doc='Global batch size; -1 = unset.')
OPTIONS.register('model_dir', '.', env='HB_MODEL_DIR',
                 doc='Directory for checkpoints and summaries.')
