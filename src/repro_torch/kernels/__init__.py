"""Hand-written CUDA kernels of the port, each beside its plain version.

``fedavg`` is the server fold (``csrc/fedavg.cu``, replacing the Pallas
``fedavg_pallas``); ``fused_aggregate`` is the async flush with a server
optimizer in one pass (``csrc/fused_aggregate.cu``, replacing
``fused_aggregate_pallas``); ``ref`` holds the plain PyTorch versions;
``build.LAUNCHES`` counts launches per kernel.
"""

from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.fedavg import fedavg  # noqa: F401
from repro_torch.kernels.fused_aggregate import FUSED_MODES, fused_aggregate  # noqa: F401
