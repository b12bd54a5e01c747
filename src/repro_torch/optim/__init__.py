from repro_torch.optim.adam import OptState, adam_init, adam_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import make_schedule

__all__ = ["OptState", "adam_init", "adam_update", "clip_by_global_norm", "make_schedule"]
