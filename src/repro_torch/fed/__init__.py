from repro_torch.fed.data import FedTask, make_synthetic_task, standard_tasks  # noqa: F401
from repro_torch.fed.trainer import MMFLTrainer, TrainConfig  # noqa: F401
