"""The JAX package's per-op mixed-precision policy, for ``auto_cast`` with
custom white and black lists.

Counterpart of the dispatch hook of ``paddle_tpu/amp/auto_cast.py``
(``_hook``): at every op of the registry, by the op's Paddle name,

- an op of the black list with any float16 or bfloat16 input computes in
  float32 (every floating input is cast to float32);
- at O2, or for an op of the white list, every floating input is cast to
  the AMP type;
- any other op runs in the types it receives.

The lists start from the op specs (``amp: white`` / ``amp: black`` in
``paddle_tpu/ops/specs/*.yaml``, read by ``spec_meta.amp_white()`` /
``amp_black()``): :data:`WHITE` and :data:`BLACK` are the port's copies,
held equal to them by a CPU test.  ``custom_white_list`` moves names onto
the white list and off the black one, ``custom_black_list`` the other way
(``auto_cast.__init__``, ``:82-91``).

The port has no op registry: it enforces the policy with
:class:`ListCastMode`, a ``torch.overrides.TorchFunctionMode`` that maps
each torch callable it sees to its Paddle name through :data:`OPS` (a
function mode, not a dispatch mode: under a dispatch mode ``linear`` and
``matmul`` have already become ``mm`` / ``addmm`` and could not be told
apart).  A name outside the table raises ``NotImplementedError``: the JAX
package accepts any string, and a silent ignore would drop a cast the
caller asked for.  Names of ops the port does not have yet
(``fused_feedforward``, ``fused_multi_head_attention``,
``sigmoid_focal_loss``: ROADMAP.md A.9) map to no callable.

The port's own attention and norm functions (``sdpa`` in
``nn/functional/attention.py``, ``flash_attention`` in
``ops/flash_attention.py``, ``rms_norm`` in ``nn/functional/norm.py``)
are not torch functions, so the mode never sees them: they call
:func:`cast_inputs` with their Paddle name and run their insides under
:func:`outside_lists`, as a registry op's insides run in the type its
inputs were cast to.

Cost: one Python call per torch function while the mode is on (a dict
lookup for an unmapped one).  ``chip_smoke.py`` phase 24 measures it on
GPT-3 1.3B's training step.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["WHITE", "BLACK", "OPS", "ListCastMode", "lists_with", "enter",
           "cast_inputs", "outside_lists"]

# the JAX package's O1 lists (``amp_white()`` and ``amp_black()`` of
# paddle_tpu/ops/spec_meta.py), copied
WHITE = frozenset({
    "addmm", "bmm", "conv_nd", "conv_transpose_nd", "einsum",
    "flash_attention", "fused_feedforward", "fused_multi_head_attention",
    "gru_cell", "linear", "lstm_cell", "matmul", "mm", "multi_dot", "mv",
    "rnn_scan", "sdpa"})
BLACK = frozenset({
    "acosh", "asinh", "atanh", "batch_norm_apply", "bce", "bce_with_logits",
    "cosh", "cross_entropy", "cumprod", "cumsum", "erfinv", "exp", "expm1",
    "group_norm", "instance_norm", "kl_div", "l1_loss", "layer_norm", "log",
    "log10", "log1p", "log2", "log_softmax", "logsumexp", "mean",
    "mse_loss", "nll_loss", "p_norm", "pow", "reciprocal", "rms_norm",
    "rsqrt", "sigmoid_focal_loss", "sinh", "softmax",
    "softmax_with_cross_entropy", "square", "std", "sum", "tan", "var"})

_T = torch.Tensor


def _fns(*names, tensor=(), functional=()):
    """torch.<name>, Tensor.<name> and F.<name> callables that exist."""
    out = [getattr(torch, n) for n in names if hasattr(torch, n)]
    out += [getattr(_T, n) for n in names + tuple(tensor) if hasattr(_T, n)]
    out += [getattr(F, n) for n in functional]
    return tuple(out)


# Paddle op name -> the torch callables it covers (as the mode sees them:
# ``x + y`` arrives as ``Tensor.add``, ``x @ y`` as ``Tensor.matmul``)
OPS = {
    # the white list
    "linear": (F.linear,),
    "matmul": _fns("matmul", tensor=("__matmul__", "__rmatmul__")),
    "mm": _fns("mm"),
    "bmm": _fns("bmm"),
    "addmm": _fns("addmm"),
    "mv": _fns("mv"),
    "einsum": (torch.einsum,),
    "multi_dot": (torch.linalg.multi_dot,),
    "conv_nd": (F.conv1d, F.conv2d, F.conv3d),
    "conv_transpose_nd": (F.conv_transpose1d, F.conv_transpose2d,
                          F.conv_transpose3d),
    "gru_cell": (torch.gru_cell,),
    "lstm_cell": (torch.lstm_cell,),
    "rnn_scan": (torch.rnn_tanh, torch.rnn_relu, torch.lstm, torch.gru),
    "sdpa": (F.scaled_dot_product_attention,),
    "flash_attention": (),          # the port's wrapper calls cast_inputs
    "fused_feedforward": (),        # not in the port yet (A.9)
    "fused_multi_head_attention": (),
    # the black list
    "softmax": _fns("softmax", functional=("softmax",)),
    "log_softmax": _fns("log_softmax", functional=("log_softmax",)),
    "layer_norm": (F.layer_norm,),
    "rms_norm": (F.rms_norm,),      # and the port's rms_norm
    "group_norm": (F.group_norm,),
    "instance_norm": (F.instance_norm,),
    "batch_norm_apply": (F.batch_norm,),
    "cross_entropy": (F.cross_entropy,),
    "softmax_with_cross_entropy": (F.cross_entropy,),
    "nll_loss": (F.nll_loss,),
    "mse_loss": (F.mse_loss,),
    "l1_loss": (F.l1_loss,),
    "kl_div": (F.kl_div,),
    "bce": (F.binary_cross_entropy,),
    "bce_with_logits": (F.binary_cross_entropy_with_logits,),
    "sigmoid_focal_loss": (),       # not in the port yet (A.9)
    "sum": _fns("sum"),
    "mean": _fns("mean"),
    "std": _fns("std"),
    "var": _fns("var"),
    "logsumexp": _fns("logsumexp"),
    "cumsum": _fns("cumsum"),
    "cumprod": _fns("cumprod"),
    "p_norm": _fns("norm") + (torch.linalg.vector_norm,),
    "pow": _fns("pow", tensor=("__pow__", "__rpow__")),
    "square": _fns("square"),
    "exp": _fns("exp"),
    "expm1": _fns("expm1"),
    "log": _fns("log"),
    "log10": _fns("log10"),
    "log1p": _fns("log1p"),
    "log2": _fns("log2"),
    "reciprocal": _fns("reciprocal"),
    "rsqrt": _fns("rsqrt"),
    "erfinv": _fns("erfinv"),
    "tan": _fns("tan"),
    "sinh": _fns("sinh"),
    "cosh": _fns("cosh"),
    "asinh": _fns("asinh"),
    "acosh": _fns("acosh"),
    "atanh": _fns("atanh"),
    # names PaddleNLP-style lists move
    "add": _fns("add", tensor=("__radd__",)),
    "divide": _fns("div", "divide", "true_divide",
                   tensor=("__truediv__", "__rtruediv__")),
    "embedding": (F.embedding,),
}

_HALF = (torch.float16, torch.bfloat16)


def lists_with(custom_white=None, custom_black=None):
    """The white and black lists with the custom ones applied, as the JAX
    ``auto_cast.__init__`` applies them; a name outside :data:`OPS`
    raises."""
    for name in (*(custom_white or ()), *(custom_black or ())):
        if name not in OPS:
            raise NotImplementedError(
                f"auto_cast: no op named {name!r} in the port's table of "
                "custom-list names (paddle_tpu_torch/amp/op_lists.py OPS)")
    white, black = set(WHITE), set(BLACK)
    if custom_white:
        white |= set(custom_white)
        black -= set(custom_white)
    if custom_black:
        black |= set(custom_black)
        white -= set(custom_black)
    return frozenset(white), frozenset(black)


def _tensors(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _cast(a, dtype):
    if isinstance(a, torch.Tensor):
        return a.to(dtype) if a.is_floating_point() and a.dtype != dtype \
            else a
    if isinstance(a, (list, tuple)):
        return type(a)(_cast(t, dtype) for t in a)
    return a


class ListCastMode(TorchFunctionMode):
    """The JAX policy over torch functions (see the module docstring).
    ``ran`` counts ``(name, dtype)`` for each mapped call: the Paddle name
    and the type its first floating input had when it ran; ``calls``
    counts every torch function the mode saw (its host cost)."""

    def __init__(self, dtype: torch.dtype, level: str, white, black):
        super().__init__()
        self.dtype, self.level = dtype, level
        self.white, self.black = white, black
        # callable -> its name; a callable of two names
        # (F.cross_entropy) takes the black one's rule if either is black
        self.names = {}
        for name, fns in OPS.items():
            if name in white or name in black or level == "O2":
                for fn in fns:
                    if self.names.get(fn) not in black:
                        self.names[fn] = name
        self.ran = collections.Counter()
        self.calls = 0

    def target(self, name, tensors):
        """The type the op ``name`` casts its floating inputs to, or
        None (as they come)."""
        if name in self.black:
            if any(t.dtype in _HALF for t in tensors):
                return torch.float32
            return None
        if self.level == "O2" or name in self.white:
            return self.dtype
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls += 1
        name = self.names.get(func)
        if name is None:
            return func(*args, **kwargs)
        dtype = self.target(name, list(_tensors(args, kwargs)))
        if dtype is not None:
            args = _cast(args, dtype)
            kwargs = {k: _cast(v, dtype) for k, v in kwargs.items()}
        self._count(name, _tensors(args, kwargs))
        return func(*args, **kwargs)

    def _count(self, name, tensors):
        for t in tensors:
            if t.is_floating_point():
                self.ran[(name, t.dtype)] += 1
                return


class _Active(threading.local):
    mode = None


_active = _Active()


@contextlib.contextmanager
def enter(mode: ListCastMode):
    """Make ``mode`` the thread's policy and push it as a function mode."""
    saved = _active.mode
    _active.mode = mode
    try:
        with mode:
            yield mode
    finally:
        _active.mode = saved


def cast_inputs(name: str, *tensors):
    """``tensors`` cast as the active policy casts the inputs of the op
    ``name`` (unchanged when no custom-list policy is active; None stays
    None).  For the port's functions that the mode cannot see."""
    mode = _active.mode
    if mode is None:
        return tensors
    present = [t for t in tensors if t is not None]
    dtype = mode.target(name, present)
    if dtype is not None:
        tensors = tuple(None if t is None else _cast(t, dtype)
                        for t in tensors)
    mode._count(name, (t for t in tensors if t is not None))
    return tensors


@contextlib.contextmanager
def outside_lists():
    """The insides of an op that :func:`cast_inputs` has cast: no policy,
    no function mode (as a registry op's insides run in the types its
    inputs were cast to)."""
    mode = _active.mode
    if mode is None:
        yield
        return
    _active.mode = None
    try:
        with torch._C.DisableTorchFunction():
            yield
    finally:
        _active.mode = mode
