"""action_detection_torch — the PyTorch and CUDA port of action_detection_tpu.

The JAX package beside it is the reference this port is tested against. The
port imports torch and never jax, flax, yaml or PIL (JPEG frames go through
its own C++ decoder), so it runs on a machine that has only torch, numpy,
g++ and the CUDA toolkit; the JAX package's orbax checkpoint directories
are read through tensorstore where it imports.

The port covers the inference pipeline: sliding windows
(``cli/gen_sliding_window_proposals.py``), dense actionness
(``cli/binary_test.py`` -> ``infer/actionness.py``), TAG grouping
(``cli/gen_bottom_up_proposals.py``), proposal scoring (``cli/ssn_test.py``
-> ``infer/scorer.py``) and evaluation (``cli/eval_detection_results.py``),
on BNInception and InceptionV3 (TinyConv for tests) with the int8
end-to-end, shared-stem default; and training (``cli/ssn_train.py``,
``cli/binary_train.py`` -> ``train/``), float32 or bf16 on the hand-written
max-pool backward, on one GPU or data parallel across GPUs and hosts.

Package layout (each module mirrors one module of action_detection_tpu):
  models/      torch model definitions, int8 runtime, weight bridge
  kernels/     hand-written CUDA int8 conv/pool and max-pool backward
               kernels, nvcc build, plain versions, launch counters
  csrc/        the CUDA C++ sources of those kernels, the C++ host
               kernels (NMS, TAG box search) and the JPEG decoder
  ops/         stpp pooling, losses, pooling (torch); iou, nms, tag, mAP,
               metrics, aggregation (host numpy)
  data/        proposal-list I/O, dataset DBs, datasets, transforms, pipeline,
               the JPEG decoder's binding
  evaluation/  detections, NMS, regression, AP table (host)
  train/       checkpoints (.pt; JAX msgpack and orbax, reference .pth read)
               carrying reg_stats, optimizer, train and eval steps, init
               weights
  infer/       the shared feature step, the proposal and actionness scorers,
               the fan-out over devices and cross-video packing
  parallel/    device selection, the process group, DDP wrapping, batch
               slices and metric means (data-parallel training)
  utils/       meters, the device trace and the scoring path's host spans,
               the build paths, the native host library
  cli/         ssn_train, binary_train, ssn_test, binary_test,
               eval_detection_results, gen_bottom_up_proposals,
               gen_sliding_window_proposals, gen_proposal_list
"""

from .config import DatasetConfig, SamplingConfig, get_configs

__version__ = "0.1.0"
