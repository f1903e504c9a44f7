"""The paper's control plane (``repro.core``), as far as the closed loop
reaches it: monitoring (collection, anomaly detection), scaling (the
DynamicScaler and the eviction policy), allocation (the workload
forecaster, the DQN over the multi-stream DNN and the predictive allocator)
and the DNN with its feature streams.  Offline training, trace replay,
orchestration and the adaptation engine are not ported yet."""
