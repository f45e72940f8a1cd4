"""The trainer's side of elastic training: resume, step, report, save.

Counterpart of ``paddle_tpu/distributed/fleet/elastic/loop.py``.
``run_elastic`` joins the launcher's restart generations
(``distributed/launch/main.py``: a node's death or a worker's failure
bumps the generation and the world settles again) to the resume of a
ZeRO-3 state at another dp (``fleet.hybrid_step.load_zero3_state``).
Every worker runs the same loop: read the settled world from the
launcher's environment, restore the newest COMPLETE checkpoint if there
is one (whatever dp wrote it), then step, so the workers of any new
generation go on where the job stopped.

``ProgressReporter`` is the worker's half of the launcher's progress
watchdog (``ELASTIC_STALL_TIMEOUT_S``): a step heartbeat on
``progress/{generation}/{rank}`` of the launcher's store.  It is
optional (a script that never reports is never stall-killed) and best
effort (a store hiccup drops a heartbeat, never the training).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from ....observability import flight_recorder as _flight
from ....observability import metrics as _metrics
from ....testing import chaos as _chaos
from ...store import TCPStore

__all__ = ["ElasticContext", "ProgressReporter", "run_elastic",
           "zero3_elastic_hooks"]


@dataclass
class ElasticContext:
    """The settled world as the launcher told this worker."""

    generation: int
    rank: int
    world_size: int
    local_rank: int
    nnodes: int
    master: Optional[str]

    @classmethod
    def from_env(cls, env=None) -> "ElasticContext":
        e = os.environ if env is None else env
        return cls(
            generation=int(e.get("PADDLE_RESTART_GENERATION", "0")),
            rank=int(e.get("PADDLE_TRAINER_ID", "0")),
            world_size=int(e.get("PADDLE_TRAINERS_NUM", "1")),
            local_rank=int(e.get("PADDLE_LOCAL_RANK", "0")),
            nnodes=int(e.get("PADDLE_NNODES", "1")),
            master=e.get("PADDLE_MASTER") or None,
        )


class ProgressReporter:
    """The worker's step heartbeat for the stall watchdog.  Every publish
    passes the ``elastic.step`` delay site, so ``chaos.delay_at`` can
    freeze it (a wedged collective, in tests)."""

    def __init__(self, ctx: Optional[ElasticContext] = None,
                 store: Optional[TCPStore] = None, env=None):
        self.ctx = ctx or ElasticContext.from_env(env)
        self._store = store
        self._enabled = store is not None or bool(self.ctx.master)

    def _get_store(self) -> Optional[TCPStore]:
        if self._store is None and self._enabled:
            host, port = self.ctx.master.rsplit(":", 1)
            try:
                self._store = TCPStore(host=host, port=int(port))
            except (OSError, TimeoutError, ValueError):
                self._enabled = False   # no store: no heartbeats
        return self._store

    def publish(self, step: int) -> None:
        _chaos.maybe_delay("elastic.step")
        if not self._enabled:
            return
        store = self._get_store()
        if store is None:
            return
        key = f"progress/{self.ctx.generation}/{self.ctx.rank}"
        try:
            store.set(key, str(int(step)))
        except (OSError, TimeoutError):
            pass    # a dropped heartbeat never stops the training


def run_elastic(step_fn: Callable[[Any, int, ElasticContext], Any],
                manager,
                *,
                init_fn: Callable[[ElasticContext], Tuple[Any, int]],
                restore_fn: Callable[[Any, ElasticContext],
                                     Tuple[Any, int]],
                save_fn: Optional[Callable[..., Any]] = None,
                max_steps: int,
                save_every: int = 1,
                ctx: Optional[ElasticContext] = None,
                reporter: Optional[ProgressReporter] = None,
                env=None) -> Tuple[Any, int]:
    """Run ``step_fn(state, step, ctx)`` to ``max_steps`` under elastic
    supervision.

    On entry (each generation: the launcher starts new workers after a
    bump) a COMPLETE checkpoint of ``manager`` (a ``CheckpointManager``)
    makes this a resume: ``restore_fn(manager, ctx)`` rebuilds
    ``(state, start_step)`` for the world as it is now
    (:func:`zero3_elastic_hooks` reshards a ZeRO-3 state to this dp);
    without one, ``init_fn(ctx)`` starts cold.  Each step publishes the
    heartbeat; every ``save_every`` steps ``save_fn(manager, step,
    state, ctx)`` versions the state, so a death costs at most
    ``save_every`` steps again.

    A resume restores what ``save_fn`` saved and nothing else: no data
    loader position, RNG stream or host state (derive them from the step
    index).  Returns ``(state, steps_completed)``."""
    ctx = ctx or ElasticContext.from_env(env)
    rep = reporter or ProgressReporter(ctx=ctx, env=env)
    _metrics.gauge("elastic.generation",
                   "current elastic restart generation of this launcher"
                   ).set(ctx.generation)
    latest = manager.latest_complete()
    if latest is not None:
        state, step = restore_fn(manager, ctx)
        _metrics.counter("elastic.resumes_total",
                         "elastic auto-resumes from a COMPLETE checkpoint "
                         "(one per worker per restart generation)").inc()
        _flight.default_recorder().record_event(
            "elastic_resume", generation=ctx.generation, step=step,
            world_size=ctx.world_size, checkpoint=latest)
    else:
        state, step = init_fn(ctx)
    while step < max_steps:
        state = step_fn(state, step, ctx)
        step += 1
        rep.publish(step)
        if save_fn is not None and save_every > 0 \
                and step % save_every == 0:
            save_fn(manager, step, state, ctx)
    return state, step


def zero3_elastic_hooks(hcg, cfg, params_fn, grain: int = 0):
    """``(init_fn, restore_fn, save_fn)`` wiring :func:`run_elastic` to
    the fused ZeRO-3 state of ``fleet.hybrid_step``.

    ``hcg``: the topology (a ``HybridCommunicateGroup``, the dp degree,
    or None: ``fleet.init``'s), whose dp is ``cfg.dp``.  A cold start cuts
    ``params_fn(ctx)`` (the serial tree) into this rank's ``[Fp / dp]``
    slices with zero moments (``init_zero3_state``); a resume loads them
    through ``load_zero3_state`` at this dp (bit-exact at any dp when
    the run keeps one ``grain``); a save versions the slices and moments
    with ``save_zero3_state(..., wait=True)``.  The state is a dict of
    ``flat``, ``m``, ``v``, ``step_no`` and ``grain``."""
    from .. import hybrid_step as hs
    if isinstance(hcg, int):
        hcg = {"dp": hcg}

    def init_fn(ctx):
        rank = hs._resolve_hcg(hcg, 1, cfg.dp, 1).get_data_parallel_rank()
        flat, m, v = hs.init_zero3_state(params_fn(ctx), cfg.dp, rank)
        return {"flat": flat, "m": m, "v": v,
                "step_no": 0.0, "grain": int(grain)}, 0

    def restore_fn(manager, ctx):
        flat, m, v, step_no, g = hs.load_zero3_state(manager, hcg, cfg)
        state = {"flat": flat, "m": m, "v": v,
                 "step_no": step_no, "grain": int(g)}
        return state, int(manager.latest_complete())

    def save_fn(manager, step, state, ctx):
        hs.save_zero3_state(manager, step, state["flat"], state["m"],
                            state["v"], state["step_no"], state["grain"],
                            wait=True, cfg=cfg, hcg=hcg)

    return init_fn, restore_fn, save_fn
