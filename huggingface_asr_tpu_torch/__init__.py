"""PyTorch/CUDA port of ``huggingface_asr_tpu`` for NVIDIA Hopper (H100).

The JAX package next to this one is the reference. This package imports
``torch`` and never ``jax``. Plain tensor code is PyTorch; the work that the
JAX package runs as Pallas TPU kernels runs here as CUDA C++ kernels written
for ``sm_90a`` (``csrc/``), built with ``nvcc`` at their first call and bound
with ``ctypes`` (``kernels/_build.py``). Importing the package needs neither
``nvcc`` nor a GPU.

Layout (each module names its JAX counterpart):

* ``models/``   — configs, the plain E-Branchformer CTC model, ``ctc_infer``,
  the DeCRED decoder and the joint CTC/attention model
* ``decoding/`` — the CTC prefix scorer, the joint beam search, ``generate_joint``
* ``cli/``      — ``train_ctc`` and ``evaluate`` (CTC and joint routes), and what they share
* ``data/``     — the CLIs' data path: datasets, collation, bucketing, prefetch, augmentation
* ``ops/``      — length math, the plain log-mel front end, CTC greedy decode
* ``kernels/``  — one file per Pallas file: weight folds, plain versions and
  the CUDA kernel wrappers
* ``csrc/``     — the ``.cu`` / ``.cuh`` kernel sources
* ``interop/``  — Flax parameter tree <-> this package's state dict
* ``training/`` — ``CTCTrainer``, model directories and checkpoints
* ``serving/``  — ``ASRPipeline`` (joint CTC/attention or CTC) and ``EndpointHandler``
* ``assets/``   — the transcript gate's model, trained by the JAX CLIs, and JAX's ids for it
"""

__version__ = "0.1.0"
