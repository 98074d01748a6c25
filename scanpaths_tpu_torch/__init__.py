"""scanpaths_tpu_torch — the PyTorch/CUDA port of ``scanpaths_tpu``.

The JAX package beside it is the reference each ported piece is held
against.  This package imports ``torch`` and never ``jax``, and nothing
of the JAX package: the numpy modules it needs from there are copied
under the same paths (``core/``, ``data/transforms.py``,
``metrics/{scanmatch,multimatch,vame,evaluation}.py``,
``utils/logger.py``).

Layout (each module keeps its counterpart's path in ``scanpaths_tpu``):
  csrc/     hand-written CUDA kernels for Hopper (sm_90a)
  ops/      kernel builder and wrappers (cell, block, nw), sampler
  models/   dilated ResNet-50, decoder components, the OSIE model,
            weight conversion
  data/     the evaluation split (OSIE)
  metrics/  device metrics, the device evaluation sweep, the host suite
  serve/    the predictor behind the CLIs
  train/    the evaluator behind the test CLI
  cli/      predict (serving) and test (evaluation) entry points
"""
