"""The host-level pipeline schedule: counterpart of
``paddle_tpu/distributed/fleet/pipeline_parallel.py`` (Paddle's
``meta_parallel/pipeline_parallel.py``: ``PipelineParallel``,
``forward_backward_pipeline``, ``PipelineParallelWithInterleave``).

The JAX package's class is its host path: every process holds every
stage and runs them back to back, so a step is the pipeline's serial
arithmetic (micro-batch split, F-then-B order, gradient accumulation,
loss averaging).  The port keeps exactly that.  Stage ownership and the
p2p schedules are :mod:`.spmd_pipeline` (``pipeline_forward``,
``interleaved_pipeline_forward``) and :mod:`.hybrid_step`.
"""

from __future__ import annotations

import torch

from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave"]


class PipelineParallel:
    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        acc = 1
        if strategy is not None:
            acc = strategy.pipeline_configs.get("accumulate_steps", 1)
        self.accumulate_steps = acc
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage_id = hcg.get_stage_id()
        self.total_loss = None

    def _split_microbatches(self, data):
        """``accumulate_steps`` equal micro-batches of x and y; a batch
        that does not divide raises the reference's ``ValueError``
        (``ops.manipulation.split``) before any forward."""
        x, y = data
        mbs = self.accumulate_steps
        if mbs == 1:
            return [x], [y]
        for t in (x, y):
            if t.shape[0] % mbs:
                raise ValueError(
                    "array split does not result in an equal division: "
                    f"{t.shape[0]} rows into {mbs} micro-batches")
        return torch.chunk(x, mbs, dim=0), torch.chunk(y, mbs, dim=0)

    def forward_backward_pipeline(self, data, scaler=None):
        """F-then-B with gradient accumulation (1F1B's arithmetic is the
        same; only the order, which matters for memory, differs)."""
        xs, ys = self._split_microbatches(data)
        total = None
        for x, y in zip(xs, ys):
            out = self._layers.forward(x)
            loss = self._layers._loss_fn(out, y)
            if scaler is not None:
                scaler.scale(loss / len(xs)).backward()
            else:
                (loss / len(xs)).backward()
            total = loss.detach() if total is None else total + loss.detach()
        self.total_loss = total / len(xs)
        return self.total_loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        xs, ys = self._split_microbatches(data)
        total = None
        for x, y in zip(xs, ys):
            out = self._layers.forward(x)
            if compute_loss:
                loss = self._layers._loss_fn(out, y)
                total = loss if total is None else total + loss
        return total / len(xs) if total is not None else None

    # the accessors
    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.load_state_dict(state_dict, *a, **k)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self


class PipelineParallelWithInterleave(PipelineParallel):
    """The interleaved (virtual-pipeline) schedule runs per rank over p2p
    (``spmd_pipeline.interleaved_pipeline_forward``); the host path
    cannot interleave and refuses."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "interleaved pipelining runs on the per-rank path: "
            "paddle_tpu_torch.distributed.fleet.spmd_pipeline."
            "interleaved_pipeline_forward (Megatron VPP schedule over the "
            "pipeline group's ring)")
