"""Mixture-of-experts.  Counterpart of
``paddle_tpu/incubate/distributed/models/moe/``."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, capacity
from .moe_layer import ExpertMLP, MoELayer

__all__ = ["MoELayer", "ExpertMLP", "BaseGate", "NaiveGate", "SwitchGate",
           "GShardGate", "capacity"]
