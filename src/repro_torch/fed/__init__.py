from repro_torch.fed.async_engine import (AsyncConfig, AsyncHistory,  # noqa: F401
                                          AsyncMMFLEngine, FedAsyncTask,
                                          client_speeds, resolve_buffer_size)
from repro_torch.fed.data import FedTask, make_synthetic_task, standard_tasks  # noqa: F401
from repro_torch.fed.trainer import MMFLTrainer, TrainConfig  # noqa: F401
