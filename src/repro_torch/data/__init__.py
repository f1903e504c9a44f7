"""The counted token pipeline (``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline, extra_inputs

__all__ = ["DataConfig", "TokenPipeline", "extra_inputs"]
