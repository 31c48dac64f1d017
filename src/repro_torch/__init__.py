"""PyTorch/CUDA port of the FedFairMMFL reproduction.

The package mirrors ``src/repro`` module for module and is tested against
it; it imports ``torch`` and ``numpy`` and nothing of the JAX package.
Checkpoints (``checkpoint``) use the JAX package's on-disk layout, so a
step written by either package resumes in the other. Entry points
(``api.run_scenario``, ``fed.trainer.MMFLTrainer``, the
execution backends, ``launch.train`` and ``launch.serve``) take
``device=None``, which means CUDA: without a
card they raise unless the caller passes ``device="cpu"``
(``repro_torch.device``).
"""

from repro_torch.device import resolve_device  # noqa: F401
