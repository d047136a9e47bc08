"""Criteo training through the flax adapter (Keras-wrapping parity).

The reference's Keras path wraps a stock ``tf.keras.Model`` so it
trains hybrid-parallel
(``/root/reference/docs/tutorial/ranking/criteo/train_keras.py`` +
``hybridbackend/tensorflow/keras/model.py:462-850``). This is the
JAX analogue: a stock flax tower wrapped by
``wraps_flax_module`` — tables sharded/stacked/exchanged by the
framework, the tower replicated, full
compile/fit/evaluate/save_weights lifecycle.

  python examples/criteo/train_flax.py --synthesize --steps 200 [--cpu 8]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import argparse
import os
import tempfile

import numpy as np

NUM_DENSE = 13
NUM_CAT = 26


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--data', default=None)
  p.add_argument('--synthesize', action='store_true')
  p.add_argument('--steps', type=int, default=200)
  p.add_argument('--batch-size', type=int, default=4096)
  p.add_argument('--dim', type=int, default=16)
  p.add_argument('--model-dir', default=None)
  p.add_argument('--cpu', type=int, default=0,
                 help='simulate N CPU devices')
  args = p.parse_args()

  if args.cpu:
    from hybridbackend_tpu.framework.platform import force_host_devices
    force_host_devices(args.cpu)
  else:
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  import flax.linen as nn
  import jax
  import jax.numpy as jnp
  import optax

  import hybridbackend_tpu as hb
  from hybridbackend_tpu.embedding import TableConfig
  from hybridbackend_tpu.flax_support import wraps_flax_module
  from hybridbackend_tpu.models import EmbeddingSpec

  vocabs = [max(100, (7919 * (c + 1)) % 100000) for c in range(NUM_CAT)]

  data = args.data
  if args.synthesize:
    from examples.criteo.train import synthesize
    data = os.path.join(tempfile.gettempdir(), 'criteo_flax.parquet')
    if not os.path.exists(data):
      synthesize(data, 200_000, vocabs)

  class Tower(nn.Module):
    """Stock MLP tower over concatenated features."""

    @nn.compact
    def __call__(self, x):
      for w in (512, 256, 64):
        x = nn.relu(nn.Dense(w)(x))
      return nn.sigmoid(nn.Dense(1)(x))[..., 0]

  specs = [EmbeddingSpec(TableConfig(f'c{c}', vocabs[c], args.dim))
           for c in range(NUM_CAT)]
  wrapped = wraps_flax_module(
      Tower(), specs, dense_columns=[f'i{d}' for d in range(NUM_DENSE)])

  from hybridbackend_tpu.data import Field, ParquetDataset
  fields = ([Field(f'c{c}', np.int64) for c in range(NUM_CAT)]
            + [Field(f'i{d}', np.float32) for d in range(NUM_DENSE)]
            + [Field('label', np.float32)])
  ds = ParquetDataset([data], fields=fields, batch_size=args.batch_size)

  example = next(iter(ds))
  params = wrapped.init(jax.random.PRNGKey(0), example)
  wrapped.compile(params, optax.adagrad(0.1), model_dir=args.model_dir)
  metrics = wrapped.fit(iter(ds), max_steps=args.steps, sync=False)
  print('train:', metrics)
  results = wrapped.evaluate(iter(ds.take(20)))
  print('eval:', results)


if __name__ == '__main__':
  main()
