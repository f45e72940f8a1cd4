"""fleet: the hybrid-parallel entry points.  Counterpart of
``paddle_tpu/distributed/fleet/fleet.py`` (Paddle's ``fleet.init``,
``distributed_model``, ``distributed_optimizer`` and
``DistributedStrategy.hybrid_configs``).

``init`` builds the topology of ``strategy.hybrid_configs`` over the
job's ranks (joining the launcher's job first, ``init_parallel_env``,
when there is more than one rank).  ``distributed_model`` wraps a model
in ``DataParallel`` over the data-parallel group when ``dp_degree`` > 1,
and a ``PipelineLayer`` in ``PipelineParallel`` when ``pp_degree`` > 1
(anything else raises ``TypeError`` there).
``distributed_optimizer`` gives a :class:`HybridParallelOptimizer`: where
the ranks split the gradients (``mp_degree`` or ``sharding_degree`` >
1) its steps sum their norms and ``found_inf`` over those groups
(``norm.py``), which the JAX package gets from GSPMD's global arrays;
with ``sharding_degree`` > 1 it steps through ZeRO
(``sharding.py``, ``strategy.sharding_configs["stage"]``).
"""

from __future__ import annotations

from typing import Optional

from .. import collective as _coll
from ..env import get_rank, get_world_size
from .norm import CrossRankNorm
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "HybridParallelOptimizer", "worker_index", "worker_num",
           "is_first_worker", "barrier_worker"]


class DistributedStrategy:
    """The strategy's fields (the reference's protobuf
    ``DistributedStrategy``)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.sharding_configs = {"stage": 1}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.find_unused_parameters = False

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


_fleet_state = {"hcg": None, "strategy": None, "initialized": False}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO"):
    """Build the hybrid topology of ``strategy.hybrid_configs`` over the
    job's ranks; returns the ``HybridCommunicateGroup``."""
    from .. import env as _env
    from ..parallel import init_parallel_env
    strategy = strategy or DistributedStrategy()
    if get_world_size() > 1 and not _env.is_initialized():
        init_parallel_env()
    hc = strategy.hybrid_configs
    topo = CommunicateTopology(
        hybrid_group_names=["data", "pipe", "sharding", "sep", "model"],
        dims=[hc.get("dp_degree", 1), hc.get("pp_degree", 1),
              hc.get("sharding_degree", 1), hc.get("sep_degree", 1),
              hc.get("mp_degree", 1)])
    hcg = HybridCommunicateGroup(topo)
    _fleet_state.update(hcg=hcg, strategy=strategy, initialized=True)
    return hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _fleet_state["hcg"] is None:
        raise RuntimeError("call fleet.init first")
    return _fleet_state["hcg"]


def distributed_model(model):
    """``model`` wrapped by the parallel degrees: ``PipelineParallel``
    over a ``PipelineLayer`` when ``pp_degree`` > 1, ``DataParallel``
    over the data-parallel group when ``dp_degree`` > 1, else
    ``model``.

    ``PipelineParallel`` is the host path: it runs every stage in each
    process and communicates nothing, so beside ``pp_degree`` > 1 any
    other degree above 1 (whose gradients it would never sum) raises:
    ``hybrid_step.make_hybrid_train_step`` runs pp with dp, mp and
    ZeRO."""
    from .sharding import mark_jax_layout
    hcg = get_hybrid_communicate_group()
    strategy = _fleet_state["strategy"]
    if hcg.get_pipe_parallel_world_size() > 1:
        from .pipeline_parallel import PipelineParallel
        from .pp_layers import PipelineLayer
        if not isinstance(model, PipelineLayer):
            raise TypeError("fleet.distributed_model with pp_degree > 1 "
                            "needs a PipelineLayer")
        others = {"dp_degree": hcg.get_data_parallel_world_size(),
                  "mp_degree": hcg.get_model_parallel_world_size(),
                  "sharding_degree":
                      hcg.get_sharding_parallel_world_size()}
        if any(d > 1 for d in others.values()):
            raise NotImplementedError(
                f"fleet.distributed_model at pp_degree > 1 with {others}: "
                "PipelineParallel sums no gradient across ranks; use "
                "hybrid_step.make_hybrid_train_step (or "
                "spmd_pipeline.pipeline_forward) for pp with dp, mp or "
                "sharding")
        return PipelineParallel(model, hcg, strategy)
    mark_jax_layout(model)
    if hcg.get_data_parallel_world_size() > 1:
        from ..parallel import DataParallel
        return DataParallel(
            model, group=hcg.get_data_parallel_group(),
            find_unused_parameters=bool(strategy.find_unused_parameters)
            if strategy else False)
    return model


def _norm_groups(hcg) -> CrossRankNorm:
    return CrossRankNorm({"mp": hcg.get_model_parallel_group(),
                          "sharding": hcg.get_sharding_parallel_group()})


class HybridParallelOptimizer:
    """Paddle's ``hybrid_parallel_optimizer.py``: the inner optimizer
    with its norms and ``found_inf`` summed over the groups that split
    the gradients, stepped through ZeRO when ``sharding_degree`` > 1."""

    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._sharding = None
        if hcg.get_sharding_parallel_world_size() > 1:
            from .sharding import DygraphShardingOptimizer
            stage = (strategy.sharding_configs.get("stage", 1)
                     if strategy is not None else 1)
            self._sharding = DygraphShardingOptimizer(optimizer, hcg,
                                                      stage=stage)
        else:
            optimizer._set_grad_reduce(_norm_groups(hcg))

    def step(self):
        if self._sharding is not None:
            self._sharding.step()
        else:
            self._inner_opt.step()

    def _scaler_step(self, scaler):
        if self._sharding is not None:
            self._sharding._scaler_step(scaler)
        else:
            scaler._step(self._inner_opt)

    def _before_unscale(self):
        if self._sharding is not None:
            self._sharding._before_unscale()

    def clear_grad(self, *a, **k):
        if self._sharding is not None:
            self._sharding.clear_grad(*a, **k)
        else:
            self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)


def distributed_optimizer(optimizer, strategy=None):
    hcg = get_hybrid_communicate_group()
    return HybridParallelOptimizer(optimizer, hcg,
                                   strategy or _fleet_state["strategy"])


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_first_worker():
    return get_rank() == 0


def barrier_worker():
    if get_world_size() > 1:
        _coll.barrier()
