"""Success-chance-driven autoscaling (DESIGN.md §2.7).

The elasticity subsystem shared by the serving engine, the discrete-event
simulator and the cluster front door: a pluggable scale-up/scale-down
policy (``SCALER_POLICIES``) driven by the Ch. 5 chance-of-success signal
instead of raw queue depth, an explicit machine-seconds cost model, and a
``PoolScaler`` driver that plugs into the control plane's
``Substrate.before_mapping`` seam (per-plane machine pools) or the Router
(whole-plane elasticity).
"""

from .config import ElasticityConfig
from .policies import (SCALER_POLICIES, CostAwareScaler, QueueScaler,
                       ScalerPolicy, SuccessChanceScaler, make_scaler_policy)
from .scaler import PoolScaler
from .signals import ScaleSignals, batch_chances

__all__ = [
    "ElasticityConfig",
    "ScalerPolicy", "QueueScaler", "SuccessChanceScaler", "CostAwareScaler",
    "SCALER_POLICIES", "make_scaler_policy",
    "PoolScaler", "ScaleSignals", "batch_chances",
]
