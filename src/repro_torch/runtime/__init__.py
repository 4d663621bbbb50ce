"""Fault-tolerance runtime: heartbeats, straggler detection, elastic
rescale (:mod:`repro_torch.runtime.fault`)."""
from repro_torch.runtime.fault import (ElasticPolicy, HeartbeatMonitor,
                                       StragglerDetector)

__all__ = ["ElasticPolicy", "HeartbeatMonitor", "StragglerDetector"]
