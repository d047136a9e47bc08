"""hybridbackend_tpu: a wide-and-deep recommender framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of
DeepRec-AI/HybridBackend (reference at /root/reference): columnar
Parquet/ORC ingest of ragged categorical features, row-sharded embedding
tables with all-to-all / all-gather exchange between devices, data-parallel
dense towers, in-training evaluation with globally exact metrics, and
world-size-independent sharded checkpointing.
"""

__version__ = '0.1.0'

from hybridbackend_tpu.framework.context import (
    Context, build_mesh, context_scope, embedding_scope, scope)
from hybridbackend_tpu.framework.options import OPTIONS

from hybridbackend_tpu import data
from hybridbackend_tpu import distribute
from hybridbackend_tpu import embedding
from hybridbackend_tpu import estimator
from hybridbackend_tpu import metrics
from hybridbackend_tpu import models
from hybridbackend_tpu import pipeline
from hybridbackend_tpu import training
from hybridbackend_tpu.estimator import SparseTrainer, Trainer


def wraps(obj):
  """Generic adoption wrapper (reference ``hb.wraps``,
  ``tensorflow/wraps.py:30-37``): routes an object to the matching
  hybrid-parallel adapter — an ``optax.GradientTransformation`` becomes
  a params-aware multi-optimizer factory (same transform for tables and
  dense, sharding-aware state), a flax ``nn.Module`` class/instance is
  returned for use with :func:`flax_support.wraps_flax_module`.
  Unrecognized objects pass through unchanged.
  """
  import optax as _optax
  if isinstance(obj, _optax.GradientTransformation):
    from hybridbackend_tpu.training import multi_optimizer
    return multi_optimizer(obj, obj)
  try:
    import flax.linen as _nn
    is_module = (isinstance(obj, _nn.Module)
                 or (isinstance(obj, type) and issubclass(obj, _nn.Module)))
  except ImportError:
    is_module = False
  if is_module and not isinstance(obj, type):
    import functools
    from hybridbackend_tpu.flax_support import wraps_flax_module
    return functools.partial(wraps_flax_module, obj)
  return obj
