"""Hand-written CUDA kernels of the port, each beside its plain version.

``fedavg`` is the server fold (``csrc/fedavg.cu``, replacing the Pallas
``fedavg_pallas``); ``fused_aggregate`` is the async flush with a server
optimizer in one pass (``csrc/fused_aggregate.cu``, replacing
``fused_aggregate_pallas``); ``flash_attention`` is the LM's forward
attention (``csrc/flash_attention.cu``, replacing
``flash_attention_pallas``); ``rmsnorm`` is every norm of the LMs
(``csrc/rmsnorm.cu``, replacing ``rmsnorm_pallas``); ``gated_rmsnorm`` is
Mamba2's output gate (``csrc/gated_rmsnorm.cu``, replacing
``gated_rmsnorm_pallas``); ``ssd_scan`` is Mamba2's chunked state-space
scan (``csrc/ssd_scan.cu``, replacing ``ssd_scan_pallas``). ``ref`` holds
the plain PyTorch versions; every wrapper launches through
``build.launch``, which counts launches per kernel in ``build.LAUNCHES``;
``build.device_launches`` counts the device kernels of one call and
``build.graph_kernels`` names them. On meta tensors (the dry-run) each
wrapper returns its kernel's output shapes through ``shapes``, whose
operators carry the kernel's own flops and bytes.
"""

from repro_torch.kernels.build import (KERNELS, LAUNCHES, device_launches,  # noqa: F401
                                      graph_kernels, reset_launches)
from repro_torch.kernels.fedavg import fedavg  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.fused_aggregate import FUSED_MODES, fused_aggregate  # noqa: F401
from repro_torch.kernels.gated_rmsnorm import gated_rmsnorm  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
