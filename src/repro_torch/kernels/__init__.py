"""Hand-written CUDA kernels of the port, each beside its plain version.

``fedavg`` is the server fold (``csrc/fedavg.cu``, replacing the Pallas
``fedavg_pallas``); ``fused_aggregate`` is the async flush with a server
optimizer in one pass (``csrc/fused_aggregate.cu``, replacing
``fused_aggregate_pallas``); ``flash_attention`` is the LM's forward
attention (``csrc/flash_attention.cu``, replacing
``flash_attention_pallas``); ``rmsnorm`` is every norm of the dense LM
(``csrc/rmsnorm.cu``, replacing ``rmsnorm_pallas``). ``ref`` holds the
plain PyTorch versions; ``build.LAUNCHES`` counts launches per kernel.
"""

from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.fedavg import fedavg  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.fused_aggregate import FUSED_MODES, fused_aggregate  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401
