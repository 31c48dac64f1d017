"""Plain PyTorch versions of the port's kernels (the correctness oracles).

Each ``ref_*`` computes its kernel's contract with ordinary tensor ops.
The CPU path of each wrapper and the tests use them; ``chip_smoke.py``
holds every kernel against them on the card. The CUDA path never calls
them.
"""

from __future__ import annotations

import torch


def ref_fedavg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (K, N); weights: (K,) -> (N,), summed in f32 and cast
    back to ``stacked``'s dtype."""
    return torch.tensordot(weights.to(torch.float32), stacked.to(torch.float32),
                           dims=([0], [0])).to(stacked.dtype)
