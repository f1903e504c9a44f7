from repro_torch.core.scaling.scaler import (
    DynamicScaler, EvictionPolicy, PerfModel, ScalingConstraints,
    ScalingDecision, ScalingOptimizer,
)

__all__ = ["DynamicScaler", "EvictionPolicy", "PerfModel",
           "ScalingConstraints", "ScalingDecision", "ScalingOptimizer"]
