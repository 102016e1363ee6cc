"""The port's data pipeline (the reference's ``repro/data``)."""
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
