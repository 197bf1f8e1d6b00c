"""The port's data pipeline: deterministic synthetic token batches."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
