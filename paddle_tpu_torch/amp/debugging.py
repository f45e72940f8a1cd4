"""AMP debugging: counterpart of ``paddle_tpu/amp/debugging.py``
(``check_numerics``, the tensor checker's switches, operator stats).

``check_numerics`` counts a tensor's NaN and Inf values (one read back)
and raises (``DebugMode.CHECK_NAN_INF_AND_ABORT``, the default) or warns.
The tensor checker (the JAX flag ``check_nan_inf``) and the operator
stats are a ``TorchDispatchMode`` pushed while either is on: it counts
every aten op by name and, with the checker on, raises
``FloatingPointError`` naming the first op whose floating output holds a
NaN or an Inf (a read back per op: a debugging tool).  The hand-written
kernels' launches are not aten ops: neither sees them.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["check_numerics", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "DebugMode", "enable_tensor_checker", "disable_tensor_checker"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


def check_numerics(tensor, op_type="", var_name="", debug_mode=None,
                   stack_height_limit=1):
    """Scan a tensor for NaN/Inf; raises (mode 0, the default) or warns
    (mode 1)."""
    v = torch.as_tensor(tensor)
    if not v.is_floating_point():
        return tensor
    n_nan = int(torch.isnan(v).sum())
    n_inf = int(torch.isinf(v).sum())
    if n_nan or n_inf:
        msg = (f"check_numerics: op={op_type!r} var={var_name!r} has "
               f"{n_nan} NaN and {n_inf} Inf values")
        if debug_mode in (None, DebugMode.CHECK_NAN_INF_AND_ABORT):
            raise FloatingPointError(msg)
        warnings.warn(msg)
    return tensor


class _OpWatch(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.stats = None          # op name -> calls, while collecting
        self.check = False         # the tensor checker

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self.stats is not None:
            self.stats[name] = self.stats.get(name, 0) + 1
        if self.check:
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and o.is_floating_point() \
                        and not bool(torch.isfinite(o).all()):
                    raise FloatingPointError(
                        f"Ops ['{name}'] produced NaN/Inf outputs")
        return out


_watch = _OpWatch()
_pushed = False
_op_stats: dict = {}


def _sync_mode() -> None:
    """The mode is pushed while the checker or the stats are on."""
    global _pushed
    on = _watch.check or _watch.stats is not None
    if on and not _pushed:
        _watch.__enter__()
        _pushed = True
    elif not on and _pushed:
        _watch.__exit__(None, None, None)
        _pushed = False


def enable_tensor_checker():
    _watch.check = True
    _sync_mode()


def disable_tensor_checker():
    _watch.check = False
    _sync_mode()


def enable_operator_stats_collection():
    _op_stats.clear()
    _watch.stats = _op_stats
    _sync_mode()


def disable_operator_stats_collection():
    _watch.stats = None
    _sync_mode()
    if _op_stats:
        print("<{:-^60}>".format(" op list "))
        for name, count in sorted(_op_stats.items(), key=lambda x: -x[1]):
            print(f"  {name:<40} calls: {count}")


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()
