"""scanpaths_tpu_torch — the PyTorch/CUDA port of ``scanpaths_tpu``.

The JAX package beside it is the reference each ported piece is held
against.  This package imports ``torch`` and never ``jax``; from the JAX
package it imports only modules that do not import JAX
(``core/grid.py``, ``core/config.py``, ``data/transforms.py``).

Layout (each module keeps its counterpart's path in ``scanpaths_tpu``):
  csrc/    hand-written CUDA kernels for Hopper (sm_90a)
  ops/     kernel builder and wrappers (cell, block), sampler
  models/  dilated ResNet-50, decoder components, the OSIE model,
           weight conversion
  serve/   the predictor behind the serving CLI
  cli/     predict (serving entry point)
"""
