from repro_torch.data.pipeline import DataPipeline, PipelineState
from repro_torch.data.synthetic import (
    HierarchyData,
    TopicLMStream,
    classification_dataset,
    hierarchy_dataset,
    translation_dataset,
)

__all__ = ["DataPipeline", "HierarchyData", "PipelineState", "TopicLMStream",
           "classification_dataset", "hierarchy_dataset", "translation_dataset"]
