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

``resolve_device`` is re-exported lazily (PEP 562), so that importing a
torch-free subpackage (``repro_torch.analysis``) does not import torch.
"""


def __getattr__(name: str):
    if name == "resolve_device":
        from repro_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
