"""PyTorch/CUDA port of the decentralized-learning system in ``repro``.

The package mirrors the JAX package's layout (configs, data, core, models,
optim, kernels, merging, residency, wire, checkpoint, serving, telemetry,
launch) and runs its main path — decentralized training with the single
final global merge, then the merged model saved and served — on an NVIDIA
Hopper card.
The two Pallas kernels of that path are CUDA C++ kernels for ``sm_90a``
under ``kernels/csrc``; on CPU tensors their wrappers take the plain
PyTorch versions in ``kernels/ref.py``.

It imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``repro``. Float32 matrix products and convolutions run in full float32:
TF32 is switched off here, at import, for both cuBLAS and cuDNN, so the
port's numbers stay comparable with the float32 reference.
"""
import torch

from repro_torch.device import resolve_device  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
