from repro_torch.core.monitoring.anomaly import Anomaly, AnomalyDetector, trend
from repro_torch.core.monitoring.collector import (
    FLEET_EVENT_KEYS, MetricsCollector, ReplicaReport,
)

__all__ = ["Anomaly", "AnomalyDetector", "trend", "FLEET_EVENT_KEYS",
           "MetricsCollector", "ReplicaReport"]
