from repro_torch.models import heads, layers, model_zoo, transformer
from repro_torch.models.model_zoo import ModelBundle, build, cache_specs

__all__ = ["heads", "layers", "model_zoo", "transformer", "ModelBundle",
           "build", "cache_specs"]
