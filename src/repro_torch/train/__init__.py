from repro_torch.train.serve import (
    Request,
    RequestStatus,
    SamplingParams,
    Scheduler,
    ServeSession,
)
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.train.trainer import Trainer

__all__ = ["Request", "RequestStatus", "SamplingParams", "Scheduler", "ServeSession",
           "TrainState", "Trainer", "make_train_step"]
