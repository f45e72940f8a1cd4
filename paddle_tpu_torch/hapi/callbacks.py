"""Training callbacks for the high-level ``Model`` API: a copy of
``paddle_tpu/hapi/callbacks.py`` (``Callback``, ``CallbackList``,
``config_callbacks``, ``ProgBarLogger``, ``ModelCheckpoint``,
``LRScheduler`` over the port's ``optimizer/lr.py``, ``EarlyStopping``,
``ReduceLROnPlateau``).
"""

from __future__ import annotations

import numbers
import os
from typing import List, Optional

import numpy as np

from .progressbar import ProgressBar

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau"]


class Callback:
    """Base class; hook methods receive a `logs` dict."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train/eval/predict lifecycle -----------------------------------------
    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or ["loss"]})
    return cl


class ProgBarLogger(Callback):
    """Prints loss + metrics every `log_freq` steps."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")
        self.train_progbar = ProgressBar(num=self.steps,
                                         verbose=self.verbose)
        self.train_step = 0

    def _logs_values(self, logs):
        return {k: v for k, v in logs.items()
                if isinstance(v, (numbers.Number, list, tuple, np.ndarray))}

    def on_train_batch_end(self, step, logs=None):
        self.train_step += 1
        if self.verbose and self.train_step % self.log_freq == 0:
            self.train_progbar.update(self.train_step,
                                      self._logs_values(logs or {}))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            self.train_progbar.update(self.train_step,
                                      self._logs_values(logs or {}))

    def on_eval_begin(self, logs=None):
        n = (logs or {}).get("steps")
        self.eval_progbar = ProgressBar(num=n, verbose=self.verbose)
        self.eval_step = 0
        if self.verbose:
            print("Eval begin...")

    def on_eval_batch_end(self, step, logs=None):
        self.eval_step += 1
        if self.verbose and self.eval_step % self.log_freq == 0:
            self.eval_progbar.update(self.eval_step,
                                     self._logs_values(logs or {}))

    def on_eval_end(self, logs=None):
        if self.verbose:
            self.eval_progbar.update(self.eval_step,
                                     self._logs_values(logs or {}))
            print("Eval samples done")


class ModelCheckpoint(Callback):
    """Saves `{save_dir}/{epoch}` every save_freq epochs and `final`."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and \
                epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    """Stop when `monitor` stops improving."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best_value = -np.inf if mode == "max" else np.inf

    def _improved(self, cur):
        if self.mode == "max":
            return cur > self.best_value + self.min_delta
        return cur < self.best_value - self.min_delta

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = logs[self.monitor]
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.asarray(cur).reshape(-1)[0])
        if self._improved(cur):
            self.best_value = cur
            self.wait_epoch = 0
            if self.save_best_model and getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience:
            self.model.stop_training = True
            if self.verbose:
                print(f"Early stopping: {self.monitor} did not improve for "
                      f"{self.patience + 1} evals "
                      f"(best {self.best_value:.5f})")


class ReduceLROnPlateau(Callback):
    """Multiply LR by `factor` when `monitor` plateaus."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self._reset()

    def _reset(self):
        self.best = -np.inf if self.mode == "max" else np.inf
        self.wait = 0
        self.cooldown_counter = 0

    def _improved(self, cur):
        if self.mode == "max":
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = logs[self.monitor]
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.asarray(cur).reshape(-1)[0])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(cur):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                from ..optimizer.lr import LRScheduler as Sched
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    if isinstance(getattr(opt, "_lr", None), Sched):
                        import warnings
                        warnings.warn(
                            "ReduceLROnPlateau: optimizer uses an "
                            "LRScheduler; cannot override its LR — skipping")
                    else:
                        old = opt.get_lr()
                        new = max(old * self.factor, self.min_lr)
                        if old - new > 1e-12:
                            opt.set_lr(new)
                            if self.verbose:
                                print(f"ReduceLROnPlateau: lr {old:.2e} -> "
                                      f"{new:.2e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0
