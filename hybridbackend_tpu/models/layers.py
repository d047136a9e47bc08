"""Functional neural-net layers for the ranking model zoo.

Pure-functional (params-as-pytree) equivalents of the layers used by the
reference tutorial models (``/root/reference/docs/tutorial/ranking/model.py``
and ``din_layers.py``): dense/MLP with the reference's initializer scheme,
the Dice activation, and DIN's local-activation-unit attention pooling.
Everything is static-shaped and jit-friendly; matmuls run in bfloat16
when ``compute_dtype`` is set.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from hybridbackend_tpu.framework.options import OPTIONS

OPTIONS.register('compute_dtype', 'float32', env='HB_COMPUTE_DTYPE',
                 doc='Matmul compute dtype for dense towers '
                     '(float32|bfloat16); params and accumulation stay '
                     'fp32.')


def dense_init(rng: jax.Array, in_dim: int, out_dim: int,
               w_stddev: Optional[float] = None,
               b_stddev: Optional[float] = None,
               dtype=jnp.float32) -> Dict[str, jax.Array]:
  """Reference init scheme (``model.py:58-80``): normal(0, sqrt(2/(in+out)))
  weights, normal(0, sqrt(1/out)) bias."""
  kw, kb = jax.random.split(rng)
  if w_stddev is None:
    w_stddev = math.sqrt(2.0 / (in_dim + out_dim))
  if b_stddev is None:
    b_stddev = math.sqrt(1.0 / out_dim)
  return {
      'w': (jax.random.normal(kw, (in_dim, out_dim)) * w_stddev).astype(dtype),
      'b': (jax.random.normal(kb, (out_dim,)) * b_stddev).astype(dtype),
  }


def dense_apply(params: Dict[str, jax.Array], x: jax.Array,
                activation: Optional[Callable] = None,
                compute_dtype=None) -> jax.Array:
  w, b = params['w'], params['b']
  if compute_dtype is None:
    name = OPTIONS['compute_dtype']
    compute_dtype = None if name in ('float32', '') else jnp.dtype(name)
  if compute_dtype is not None:
    x = x.astype(compute_dtype)
    w = w.astype(compute_dtype)
  # Params stay fp32; the matmul runs in compute_dtype with
  # fp32 accumulation (preferred_element_type).
  y = jnp.dot(x, w, preferred_element_type=jnp.float32) + b
  if activation is not None:
    y = activation(y)
  return y


def mlp_init(rng: jax.Array, in_dim: int, dims: Sequence[int],
             dtype=jnp.float32) -> List[Dict[str, jax.Array]]:
  layers = []
  prev = in_dim
  for i, d in enumerate(dims):
    rng, sub = jax.random.split(rng)
    layers.append(dense_init(sub, prev, d, dtype=dtype))
    prev = d
  return layers


def mlp_apply(layers: List[Dict[str, jax.Array]], x: jax.Array,
              hidden_activation=jax.nn.relu,
              final_activation=None, compute_dtype=None) -> jax.Array:
  for layer in layers[:-1]:
    x = dense_apply(layer, x, hidden_activation, compute_dtype)
  return dense_apply(layers[-1], x, final_activation, compute_dtype)


# ---------------------------------------------------------------------------
# DIN layers (reference din_layers.py)
# ---------------------------------------------------------------------------

def dice_init(dim: int) -> Dict[str, jax.Array]:
  """Dice activation state (``din_layers.py:104-150``): learned alpha +
  batch statistics folded into a standardization."""
  return {'alpha': jnp.zeros((dim,), jnp.float32)}


def dice_apply(params: Dict[str, jax.Array], x: jax.Array,
               eps: float = 1e-9) -> jax.Array:
  mean = jnp.mean(x, axis=0, keepdims=True)
  var = jnp.var(x, axis=0, keepdims=True)
  x_std = (x - mean) * jax.lax.rsqrt(var + eps)
  p = jax.nn.sigmoid(x_std)
  return params['alpha'] * (1.0 - p) * x + p * x


def local_activation_unit_init(rng: jax.Array, emb_dim: int,
                               hidden_units: Sequence[int] = (80, 40)
                               ) -> Dict[str, Any]:
  """DIN's attention scorer (``din_layers.py:283-376``): MLP over
  [query, key, q-k, q*k] → scalar score."""
  in_dim = 4 * emb_dim
  rng, sub = jax.random.split(rng)
  return {
      'mlp': mlp_init(sub, in_dim, list(hidden_units) + [1]),
  }


def local_activation_unit_apply(params: Dict[str, Any], query: jax.Array,
                                keys: jax.Array) -> jax.Array:
  """query [B, D], keys [B, L, D] → scores [B, L]."""
  L = keys.shape[1]
  q = jnp.broadcast_to(query[:, None, :], keys.shape)
  att_in = jnp.concatenate([q, keys, q - keys, q * keys], axis=-1)
  scores = mlp_apply(params['mlp'], att_in,
                     hidden_activation=jax.nn.sigmoid)
  return scores[..., 0]


def attention_sequence_pooling(params: Dict[str, Any], query: jax.Array,
                               keys: jax.Array, mask: jax.Array,
                               weight_normalization: bool = False
                               ) -> jax.Array:
  """DIN AttentionSequencePoolingLayer: weighted sum of behavior-sequence
  embeddings, weights from the local activation unit, invalid positions
  masked (softmax over valid keys when ``weight_normalization``)."""
  scores = local_activation_unit_apply(params, query, keys)  # [B, L]
  if weight_normalization:
    scores = jnp.where(mask, scores, -2.0 ** 31)
    weights = jax.nn.softmax(scores, axis=-1)
  else:
    weights = jnp.where(mask, scores, 0.0)
  return jnp.einsum('bl,bld->bd', weights, keys)


__all__ = ['dense_init', 'dense_apply', 'mlp_init', 'mlp_apply',
           'dice_init', 'dice_apply', 'local_activation_unit_init',
           'local_activation_unit_apply', 'attention_sequence_pooling']
