"""Training runtime: the loop, schedules, checkpoints, metrics."""

from superresolution_for_pdes_tpu_torch.train.config import TrainConfig  # noqa: F401
from superresolution_for_pdes_tpu_torch.train.loop import train_model  # noqa: F401
from superresolution_for_pdes_tpu_torch.train.schedule import (  # noqa: F401
    EarlyStopping,
    ReduceLROnPlateau,
)
