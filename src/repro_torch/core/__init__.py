"""The paper's control plane (``repro.core``): monitoring (collection,
anomaly detection, the adaptive optimizer), scaling (the DynamicScaler and
the eviction policy), allocation (the workload forecaster, the DQN over the
multi-stream DNN and the predictive allocator), the DNN with its feature
streams, supervised training and trace-driven pretraining, and
orchestration (the strategy catalog, strategy selection and canary
rollout)."""
