from repro_torch.data.pipeline import DataPipeline, PipelineState
from repro_torch.data.synthetic import TopicLMStream

__all__ = ["DataPipeline", "PipelineState", "TopicLMStream"]
