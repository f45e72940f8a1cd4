"""Elastic training.  Counterpart of
``paddle_tpu/distributed/fleet/elastic/`` (Paddle's
``fleet/elastic/manager.py:124``): ``manager`` (``ElasticManager``: node
heartbeats, the roster and its watch, over the rendezvous store) and
``loop`` (``run_elastic``: resume, step, report and save under the
launcher's restart generations)."""

from .loop import (ElasticContext, ProgressReporter, run_elastic,  # noqa: F401
                   zero3_elastic_hooks)
from .manager import ElasticManager, ElasticStatus  # noqa: F401

__all__ = ["ElasticManager", "ElasticStatus", "ElasticContext",
           "ProgressReporter", "run_elastic", "zero3_elastic_hooks"]
