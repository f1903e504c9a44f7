from repro_torch.core.dnn.features import (
    PERF_KEYS, RESOURCE_KEYS, RunningNorm, StreamBuilder, deploy_vector,
)
from repro_torch.core.dnn.model import (
    DNNConfig, MultiStreamDNN, dnn_from_reference,
)

__all__ = ["PERF_KEYS", "RESOURCE_KEYS", "RunningNorm", "StreamBuilder",
           "deploy_vector", "DNNConfig", "MultiStreamDNN", "dnn_from_reference"]
