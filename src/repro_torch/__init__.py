"""PyTorch + CUDA port of the DS-Softmax serving system (``repro``).

The package mirrors ``repro``'s module layout: ``repro_torch.X.f`` is the
counterpart of ``repro.X.f``. It imports ``torch`` and ``numpy`` only.
Hand-written Hopper kernels live under ``csrc/`` and are built on first
use by ``kernels/_build.py``; every kernel wrapper runs its plain PyTorch
version (``kernels/ref.py``) only for tensors that lie on the CPU.
"""
