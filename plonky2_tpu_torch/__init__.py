"""plonky2_tpu_torch — the Goldilocks PLONK + FRI prover/verifier on PyTorch
tensors, with hand-written CUDA kernels for NVIDIA Hopper.

Same sub-package layout as the JAX package beside it (``field/ ops/ hash/
fri/ plonk/ gates/ iop/ utils/ models/``), so that a reader finds each
module's counterpart. Tensors are ``torch.int64`` bit containers for
canonical u64 field elements (``ops/gf.py``); entry points take
``device=None``, which means the GPU. Imports ``torch``, never ``jax`` and
nothing of the JAX package.
"""
