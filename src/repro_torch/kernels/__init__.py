"""Hand-written CUDA kernels of the port, each beside its plain version.

``fedavg`` is the server fold (``csrc/fedavg.cu``, replacing the Pallas
``fedavg_pallas``); ``ref`` holds the plain PyTorch versions;
``build.LAUNCHES`` counts launches per kernel.
"""

from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.fedavg import fedavg  # noqa: F401
