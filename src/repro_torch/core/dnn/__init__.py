"""The multi-stream DNN (``repro.core.dnn``): feature streams, the network,
its supervised training and permutation importance, and the recorded fleet
traces that pretrain it offline."""
from repro_torch.core.dnn.features import (
    PERF_KEYS, RESOURCE_KEYS, RunningNorm, StreamBuilder, deploy_vector,
)
from repro_torch.core.dnn.model import (
    DNNConfig, MultiStreamDNN, dnn_from_reference,
)
from repro_torch.core.dnn.train import (
    FEATURE_GROUPS, fit, make_sgd_step, permutation_importance,
    supervised_loss,
)
from repro_torch.core.dnn.traces import (
    TraceRecorder, fill_replay, pretrain_on_trace, replay_streams,
    supervised_dataset, transitions,
)

__all__ = ["PERF_KEYS", "RESOURCE_KEYS", "RunningNorm", "StreamBuilder",
           "deploy_vector", "DNNConfig", "MultiStreamDNN",
           "dnn_from_reference", "FEATURE_GROUPS", "fit", "make_sgd_step",
           "permutation_importance", "supervised_loss", "TraceRecorder",
           "fill_replay", "pretrain_on_trace", "replay_streams",
           "supervised_dataset", "transitions"]
