"""The high-level ``Model`` API: counterpart of
``paddle_tpu/hapi/model.py`` (``prepare`` / ``fit`` / ``evaluate`` /
``predict`` / ``save`` / ``load``) over an ``nn.Module``.

One step per mode, eager: forward (under ``auto_cast`` from
``amp_configs`` in training), the loss, backward (through the
``GradScaler`` for float16) and the optimizer's step, which on the card
is the fused ``fused_adamw`` step.  ``prepare(jit_compile=)`` is accepted
and changes nothing: the JAX package captures each mode's step into one
XLA program, while the port's step is the same eager step for both values
(a captured whole step is ROADMAP.md A.9's ``jit/`` item).

Batches come from the port's ``io.DataLoader`` on the network's device
(its parameters'); ``fit`` builds one from a ``Dataset``.  Every train
step feeds ``observability.telemetry.default_timeline()`` (one record per
step: tokens = B x S for ``[B, S]`` integer ids, else B rows) and the
``train.step_seconds`` / ``train.loss_syncs`` instruments; the loss
reaches the host once a step, as with the JAX flag
``FLAGS_loss_sync_interval`` at its default of 1.
``fit(checkpoint=, resume=)`` takes atomic, versioned checkpoints through
``distributed.checkpoint.CheckpointManager`` and resumes from them bit
for bit: parameters, optimizer and scaler state, every random source the
loop draws from (``core.random.rng_checkpoint_state`` with the network's
own generators, numpy's for the shuffle) and the loop's position.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import numpy as np
import torch
import torch.nn as nn

from .. import io as paddle_io
from ..framework import io as framework_io
from ..metric import Metric
from ..observability import flight_recorder as _flight
from ..observability import metrics as _obs_metrics
from ..observability import telemetry as _telemetry
from .callbacks import config_callbacks

__all__ = ["Model"]

_M_STEP_S = _obs_metrics.histogram(
    "train.step_seconds",
    "host wall time to dispatch one train step (labels: mode); on the "
    "card this is enqueue time unless the step syncs")
_M_LOSS_SYNC = _obs_metrics.counter(
    "train.loss_syncs",
    "host reads of the hapi train loss, one a step")

_SCALER_KEYS = ("init_loss_scaling", "incr_ratio", "decr_ratio",
                "incr_every_n_steps", "decr_every_n_nan_or_inf",
                "use_dynamic_loss_scaling")


def to_list(value):
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def _batch_tokens(inputs) -> int:
    """Telemetry tokens: a ``[B, S]`` integer batch counts B x S token
    ids, anything else its B rows."""
    if not inputs:
        return 0
    shape = tuple(getattr(inputs[0], "shape", ()) or ())
    if not shape:
        return 1
    x = inputs[0]
    ids = len(shape) == 2 and (
        (isinstance(x, torch.Tensor) and not x.is_floating_point()
         and not x.is_complex() and x.dtype != torch.bool)
        or (isinstance(x, np.ndarray) and x.dtype.kind in "iu"))
    return int(shape[0]) * int(shape[1]) if ids else int(shape[0])


def _host(t) -> np.ndarray:
    """An output on the host (bfloat16, which numpy lacks, as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Model:
    """A trainable and inferable wrapper of ``network`` (an
    ``nn.Module``).  ``inputs`` / ``labels`` say how many leading batch
    elements are inputs (the rest labels); without them the last element
    of a batch is the label."""

    def __init__(self, network: nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._amp_kwargs = None
        self._scaler = None
        self.stop_training = False
        self._save_dir = None
        self._train_steps = 0       # train_batch calls of this fit

    @property
    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    # ------------------------------------------------------------------ prep
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile: bool = True):
        """The optimizer, the loss (a callable of outputs then labels),
        metrics, and mixed precision: ``amp_configs`` "O1" / "O2" or a
        dict of ``auto_cast`` keys (``level``, ``dtype``,
        ``custom_white_list``, ...) and ``GradScaler`` keys
        (``init_loss_scaling``, ...); a scaler is made for float16 or
        when a scaler key is given."""
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be an nn.Module or a callable")
        self._loss = loss
        self._metrics = to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError("metric must be a paddle_tpu_torch.metric."
                                f"Metric, got {type(m).__name__}")
        self._amp_kwargs = None
        self._scaler = None
        if amp_configs is not None:
            cfg = {"level": amp_configs} if isinstance(amp_configs, str) \
                else dict(amp_configs)
            level = cfg.pop("level", "O1")
            if level not in ("O0", "O1", "O2"):
                raise ValueError(f"amp level must be O0/O1/O2, got {level}")
            if level != "O0":
                from .. import amp as _amp
                from ..amp.auto_cast import _check_dtype
                scaler_kw = {k: cfg.pop(k) for k in list(cfg)
                             if k in _SCALER_KEYS}
                self._amp_kwargs = {"level": level, **cfg}
                fp16 = "dtype" in cfg and _check_dtype(
                    cfg["dtype"], "prepare") == torch.float16
                if scaler_kw or fp16:
                    self._scaler = _amp.GradScaler(**scaler_kw)

    # ----------------------------------------------------------------- steps
    def _amp_ctx(self):
        if self._amp_kwargs is None:
            return contextlib.nullcontext()
        from .. import amp as _amp
        return _amp.auto_cast(True, device=self._device, **self._amp_kwargs)

    def _as_batch(self, values):
        dev = self._device
        return [v.to(dev) if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v), device=dev)
                for v in to_list(values)]

    def _run_step(self, mode, inputs, labels):
        ins, labs = self._as_batch(inputs), self._as_batch(labels)
        t0 = time.perf_counter()
        if mode in ("train", "accumulate"):
            self.network.train()
            with self._amp_ctx():
                outputs = to_list(self.network(*ins))
                loss = self._loss(*(outputs + labs))
            if self._scaler is not None:
                self._scaler.scale(loss).backward()
            else:
                loss.backward()
            if mode == "train":
                if self._scaler is not None:
                    self._scaler.step(self._optimizer)
                else:
                    self._optimizer.step()
                self._optimizer.clear_grad()
            res = [loss] + outputs
        else:
            self.network.eval()
            with torch.no_grad():
                outputs = to_list(self.network(*ins))
                res = outputs
                if mode == "eval" and self._loss is not None:
                    res = [self._loss(*(outputs + labs))] + outputs
        _M_STEP_S.observe(time.perf_counter() - t0, mode=mode)
        return res, labs

    def train_batch(self, inputs, labels=None, update=True):
        """One optimizer step (``update=False``: accumulate the gradients
        only); returns ``(loss, [metric results])``, the loss a numpy
        array (the step's one host read, inside its telemetry record)."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer=..., loss=...) first")
        self._train_steps += 1
        st = _telemetry.default_timeline().step(
            tokens=_batch_tokens(to_list(inputs)),
            mode="train" if update else "accumulate")
        with st:
            res, labs = self._run_step("train" if update else "accumulate",
                                       inputs, labels)
            loss_np = _host(res[0])
            _M_LOSS_SYNC.inc()
            st.annotate(loss=float(loss_np.reshape(-1)[0]), synced=True)
        metrics = self._update_metrics(res[1:], labs)
        _flight.check_finite(float(loss_np.reshape(-1)[0]),
                             site="hapi.train.loss",
                             step=st.index if st.index >= 0 else None)
        return loss_np, metrics

    def eval_batch(self, inputs, labels=None):
        res, labs = self._run_step("eval", inputs, labels)
        if self._loss is not None:
            return _host(res[0]), self._update_metrics(res[1:], labs)
        return None, self._update_metrics(res, labs)

    def predict_batch(self, inputs):
        res, _ = self._run_step("predict", inputs, [])
        return [_host(o) for o in res]

    def _update_metrics(self, outputs, labels):
        results = []
        for m in self._metrics:
            computed = m.compute(*(list(outputs) + list(labels)))
            results.append(m.update(*to_list(computed)))
        return results

    # ------------------------------------------------------------- save/load
    def save(self, path: str, training: bool = True):
        """``path.pdparams`` (the network's state) and, with ``training``,
        ``path.pdopt`` (the optimizer's), in the JAX package's format."""
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        framework_io.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            framework_io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        """Load ``path.pdparams`` (``skip_mismatch``: leave out entries
        the network lacks or holds in another shape) and, unless
        ``reset_optimizer``, ``path.pdopt`` where it exists."""
        params = framework_io.load(path + ".pdparams")
        if skip_mismatch:
            own = self.network.state_dict()
            params = {k: v for k, v in params.items()
                      if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.network.load_state_dict(params, strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(framework_io.load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    # -------------------------------------------------- fault-tolerant state
    def _train_state(self, epoch: int, step_in_epoch: int) -> dict:
        """Everything a resumed process needs to continue bit for bit:
        the parameters, the optimizer's state, the scaler's, every random
        source (the key chain, torch's generators and the network's, and
        numpy's now and at the epoch's start) and the loop's position."""
        from ..core import random as _random
        meta = {
            "epoch": int(epoch), "step_in_epoch": int(step_in_epoch),
            "train_steps": int(self._train_steps),
            "scaler": self._scaler.state_dict()
            if self._scaler is not None else None,
            "rng": {"framework": _random.rng_checkpoint_state(
                        _random.module_generators(self.network)),
                    "numpy": np.random.get_state(),
                    "numpy_epoch_start": getattr(self, "_epoch_np_state",
                                                 None)},
        }
        return {"model": self.network.state_dict(),
                "optimizer": self._optimizer.state_dict(),
                "meta": meta}

    def _restore_train_state(self, manager, step=None):
        """Restore the newest complete version (or ``step``) of
        ``manager``: the network, optimizer, scaler, random sources and
        the loop's counters.  Returns the restored meta, or None when the
        root holds no complete version yet (a first launch starts
        fresh)."""
        if self._optimizer is None:
            raise RuntimeError("call prepare(optimizer=..., loss=...) "
                               "before fit(resume=...)")
        if step is None:
            step = manager.latest_complete()
            if step is None:
                return None
        state = manager.load(step)
        self.network.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state["model"].items()})
        self._optimizer.set_state_dict(state["optimizer"])
        meta = state.get("meta", {})
        if self._scaler is not None and meta.get("scaler"):
            self._scaler.load_state_dict(meta["scaler"])
        rng = meta.get("rng") or {}
        if rng.get("framework") is not None:
            from ..core import random as _random
            _random.restore_rng_checkpoint_state(
                rng["framework"], _random.module_generators(self.network))
        self._train_steps = int(meta.get("train_steps", 0))
        return meta

    # ------------------------------------------------------------------- fit
    def _make_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, paddle_io.DataLoader):
            return data
        return paddle_io.DataLoader(data, batch_size=batch_size,
                                    shuffle=shuffle, drop_last=drop_last,
                                    num_workers=num_workers,
                                    device=self._device)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            checkpoint=None, resume=False):
        """Train ``epochs`` passes over ``train_data`` (a ``Dataset`` or a
        ``DataLoader``), evaluating on ``eval_data`` every ``eval_freq``
        epochs; returns the last epoch's logs.

        With ``checkpoint`` (a ``CheckpointManager`` or a root path) fit
        takes a version every ``save_interval`` optimizer steps and turns
        SIGTERM / SIGINT into a clean stop: the step in flight finishes,
        an emergency version is taken, fit returns.  ``resume=True``
        restores the newest complete version (``resume=<step>`` a given
        one) before training; an empty root starts fresh, so one launch
        command serves before and after a preemption."""
        if train_data is None:
            raise ValueError("train_data must be given")
        self._train_steps = 0
        manager = checkpoint
        if isinstance(checkpoint, (str, os.PathLike)):
            from ..distributed.checkpoint import CheckpointManager
            manager = CheckpointManager(str(checkpoint))
        start_epoch, skip_steps, resume_rng = 0, 0, None
        if resume:
            if manager is None:
                raise ValueError("fit(resume=...) requires checkpoint=...")
            meta = self._restore_train_state(
                manager, None if resume is True else int(resume))
            if meta is not None:
                start_epoch = int(meta.get("epoch", 0))
                skip_steps = int(meta.get("step_in_epoch", -1)) + 1
                resume_rng = (meta.get("rng") or {})
        train_loader = self._make_loader(train_data, batch_size, shuffle,
                                         drop_last, num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False, False,
                                        num_workers)
        self._save_dir = save_dir
        steps = len(train_loader) if hasattr(train_loader, "__len__") \
            else None
        if skip_steps and steps is not None and skip_steps >= steps:
            # the version ends an epoch: resume at the next one's top.
            # The numpy state of the save must be restored here (a resume
            # mid-epoch restores it once its skip is done, and there is
            # nothing to skip), or the next epoch's shuffle parts from the
            # uninterrupted run's
            start_epoch += 1
            if resume_rng.get("numpy") is not None:
                np.random.set_state(resume_rng["numpy"])
            skip_steps, resume_rng = 0, None
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=self._metrics_name())
        self.stop_training = False
        if manager is not None:
            from ..distributed.checkpoint import manager as _ckpt_mgr
            _ckpt_mgr.clear_preemption()
            manager.install_signal_handlers()
        logs = {}
        try:
            cbks.on_train_begin({})
            for epoch in range(start_epoch, epochs):
                cbks.on_epoch_begin(epoch, {})
                first = epoch == start_epoch
                logs = self._run_one_epoch(
                    train_loader, cbks, "train", epoch=epoch, ckpt=manager,
                    skip_steps=skip_steps if first else 0,
                    resume_rng=resume_rng if first else None)
                cbks.on_epoch_end(epoch, logs)
                if eval_loader is not None and epoch % eval_freq == 0 \
                        and not self.stop_training:
                    eval_logs = self.evaluate(eval_loader, verbose=0,
                                              _callbacks=cbks)
                    cbks.on_eval_end(eval_logs)
                if self.stop_training:
                    break
            cbks.on_train_end(logs)
        finally:
            if manager is not None:
                manager.uninstall_signal_handlers()
        if manager is not None:
            manager.wait()      # a failed trailing async save raises
        return logs

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            names.extend(to_list(m.name()))
        return names

    def _split_batch(self, batch):
        batch = to_list(batch)
        if self._inputs is not None:
            n_in = len(to_list(self._inputs))
            return batch[:n_in], batch[n_in:]
        if (self._loss is None and not self._metrics) or len(batch) < 2:
            return batch, []
        n_lab = len(to_list(self._labels)) if self._labels else 1
        return batch[:-n_lab], batch[-n_lab:]

    def _run_one_epoch(self, loader, cbks, mode, epoch=0, ckpt=None,
                       skip_steps=0, resume_rng=None):
        logs = {}
        for m in self._metrics:
            m.reset()
        if mode == "train":
            # a resumed epoch draws the shuffle the interrupted run drew
            # from the epoch's starting numpy state; the save's state is
            # restored once the skip is done (the metrics of the skipped
            # steps are not restored)
            if skip_steps and resume_rng is not None and \
                    resume_rng.get("numpy_epoch_start") is not None:
                np.random.set_state(resume_rng["numpy_epoch_start"])
            self._epoch_np_state = np.random.get_state()
        skipped = 0
        for step, batch in enumerate(loader):
            if step < skip_steps:
                skipped += 1
                continue
            if skipped and resume_rng is not None and \
                    resume_rng.get("numpy") is not None:
                np.random.set_state(resume_rng["numpy"])
                skipped = 0
            inputs, labels = self._split_batch(batch)
            getattr(cbks, f"on_{mode}_batch_begin")(step, logs)
            if mode == "train":
                loss, metrics = self.train_batch(inputs, labels)
            else:
                loss, metrics = self.eval_batch(inputs, labels)
            if loss is not None:
                logs["loss"] = float(loss.reshape(-1)[0])
            for m, res in zip(self._metrics, metrics):
                for name, val in zip(to_list(m.name()), to_list(res)):
                    logs[name] = val
            logs["batch_size"] = inputs[0].shape[0] \
                if inputs and len(inputs[0].shape) else 1
            getattr(cbks, f"on_{mode}_batch_end")(step, logs)
            if mode == "train" and ckpt is not None:
                def state_fn(e=epoch, s=step):
                    return self._train_state(e, s)
                saved = ckpt.maybe_save(self._train_steps, state_fn)
                if ckpt.preempted:
                    # the emergency version: the step in flight is done
                    if saved:
                        ckpt.wait()
                    else:
                        ckpt.save(self._train_steps, state_fn(), wait=True)
                    self.stop_training = True
                    break
        for m in self._metrics:
            for name, val in zip(to_list(m.name()), to_list(m.accumulate())):
                logs[name] = val
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _callbacks=None):
        loader = self._make_loader(eval_data, batch_size, False, False,
                                   num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = _callbacks if _callbacks is not None else config_callbacks(
            callbacks, model=self, epochs=1, steps=steps, log_freq=log_freq,
            verbose=verbose, metrics=self._metrics_name())
        cbks.on_eval_begin({"steps": steps})
        logs = self._run_one_epoch(loader, cbks, "eval")
        if _callbacks is None:
            cbks.on_eval_end(logs)
        return {k: v for k, v in logs.items() if k != "batch_size"}

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Each output of every batch as numpy (``stack_outputs``: one
        array per output, concatenated over the batches)."""
        loader = self._make_loader(test_data, batch_size, False, False,
                                   num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                metrics=[])
        cbks.on_predict_begin({})
        outputs = None
        for step, batch in enumerate(loader):
            batch, _ = self._split_batch(to_list(batch))
            cbks.on_predict_batch_begin(step, {})
            outs = self.predict_batch(batch)
            if outputs is None:
                outputs = [[] for _ in outs]
            for slot, o in zip(outputs, outs):
                slot.append(o)
            cbks.on_predict_batch_end(step, {})
        cbks.on_predict_end({})
        if outputs is None:
            return []
        if stack_outputs:
            return [np.concatenate(slot, axis=0) for slot in outputs]
        return outputs

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network)
