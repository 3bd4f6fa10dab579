"""action_detection_torch — the PyTorch and CUDA port of action_detection_tpu.

The JAX package beside it is the reference this port is tested against. The
port imports torch and never jax, flax, yaml or PIL on its main path, so it
runs on a machine that has only torch, numpy and the CUDA toolkit.

This slice covers proposal scoring (``cli/ssn_test.py`` ->
``infer/scorer.py:ProposalScorer`` -> score pickle) for RGB BNInception with
the int8 end-to-end, shared-stem default, plus the float path and TinyConv.

Package layout (each module mirrors one module of action_detection_tpu):
  models/    torch model definitions, int8 runtime, weight bridge
  kernels/   hand-written CUDA int8 conv/pool kernels, nvcc build, plain versions
  csrc/      the CUDA C++ sources of those kernels
  ops/       stpp pooling (torch), iou (host numpy)
  data/      proposal-list I/O, dataset, device transforms, host pipeline
  train/     checkpoints (.pt) carrying reg_stats
  infer/     the proposal scorer
  cli/       ssn_test
"""

from .config import DatasetConfig, SamplingConfig, get_configs

__version__ = "0.1.0"
