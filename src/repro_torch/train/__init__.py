from repro_torch.train.serve import (
    Request,
    RequestStatus,
    SamplingParams,
    Scheduler,
    ServeSession,
)

__all__ = ["Request", "RequestStatus", "SamplingParams", "Scheduler", "ServeSession"]
