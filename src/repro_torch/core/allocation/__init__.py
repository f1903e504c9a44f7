from repro_torch.core.allocation.allocator import (
    AllocatorConfig, PredictiveAllocator,
)
from repro_torch.core.allocation.forecaster import WorkloadForecaster
from repro_torch.core.allocation.rl import (
    ACTIONS, DQNAgent, DQNConfig, ReplayBuffer, reward_fn,
)

__all__ = ["AllocatorConfig", "PredictiveAllocator", "WorkloadForecaster",
           "ACTIONS", "DQNAgent", "DQNConfig", "ReplayBuffer", "reward_fn"]
