"""The port's mixture-of-experts slice against the JAX package's, on the
CPU.

The same numpy inputs (and, for GShard's random routing, the same numpy
uniforms: ``paddle_tpu.rand`` is replaced on the JAX side, the gate's
``uniforms`` on the port's) go through the JAX package and the port.  The
JAX MoE kernels (``paddle_tpu/ops/pallas_moe.py``) run in interpret mode,
with ``pl.load`` and ``pl.store``, which this jax release no longer has,
put back for the test only.  Tolerances, fp32:

- routing (expert ids, slots, keep flags, the inverse map): exact;
- ``moe_dispatch``'s plain version: exact; ``moe_combine``'s: atol 1e-6
  (both sum the same two products; XLA may fuse a multiply-add);
  their gradients against ``jax.vjp``: atol 1e-6;
- gate weights and aux losses: atol 1e-6; the dense ``(T, E, C)``
  combine weights atol 1e-6, dispatch slots exact;
- ``MoELayer`` output and every parameter's gradient, fused or dense:
  atol 1e-5;
- tiny GPT-MoE logits: atol 1e-4, loss with the aux term atol 1e-5, and
  2 AdamW steps with the bounds of ``tests/test_torch_train.py``;
- greedy serving streams: identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.flags import flag_guard
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.ops import pallas_moe as jpm
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import (adamw_state_from_numpy,
                                             state_from_numpy)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import moe as tops

M, H, E = 32, 64, 4


@pytest.fixture
def pallas_moe(monkeypatch):
    """The JAX MoE kernels call `pl.load` and `pl.store`, gone from this
    jax release; ref indexing and assignment replace them."""
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx],
                            raising=False)
    if not hasattr(pl, "store"):
        monkeypatch.setattr(pl, "store",
                            lambda ref, idx, v: ref.__setitem__(idx, v),
                            raising=False)


class _Uniforms:
    """The same stream of numpy uniforms for both frameworks' random
    routing: ``jax_rand`` stands in for ``paddle_tpu.rand``, ``port`` for
    a GShard gate's ``uniforms``."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.draws = []

    def _next(self, n):
        u = self.rng.uniform(size=(n,)).astype(np.float32)
        self.draws.append(u)
        return u

    def jax_rand(self, shape, dtype=None, name=None):
        return paddle.to_tensor(self._next(int(np.prod(shape))))

    def port(self, n, device):
        return torch.from_numpy(self._next(n)).to(device)


def _inject(monkeypatch, seed, port_modules):
    jax_u, port_u = _Uniforms(seed), _Uniforms(seed)
    monkeypatch.setattr(paddle, "rand", jax_u.jax_rand)
    for m in port_modules:
        for g in m.modules():
            if isinstance(g, tmoe.GShardGate):
                monkeypatch.setattr(g, "uniforms", port_u.port)
    return jax_u, port_u


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


# ------------------------------------------------------------------ gates

def _gate_pair(kind, zero=False, seed=0, skew=0.0):
    """The JAX gate and the port's with the same weights; ``skew`` adds
    (+skew, 0, .., -skew) to the gate's bias, so the first expert
    overflows and the last has empty slots."""
    paddle.seed(seed)
    if kind == "naive":
        jg = jmoe.NaiveGate(M, E, top_k=2, capacity_factor=1.0)
        tg = tmoe.NaiveGate(M, E, top_k=2, capacity_factor=1.0)
    elif kind == "switch":
        jg = jmoe.SwitchGate(M, E, capacity_factor=1.0)
        tg = tmoe.SwitchGate(M, E, capacity_factor=1.0)
    else:
        jg = jmoe.GShardGate(M, E)
        tg = tmoe.GShardGate(M, E)
    w = np.zeros((M, E), np.float32) if zero else _np(jg.gate.weight).copy()
    b = np.zeros((E,), np.float32) if zero else _np(jg.gate.bias).copy()
    b[0] += skew
    b[-1] -= skew
    jg.gate.weight.set_value(paddle.to_tensor(w))
    jg.gate.bias.set_value(paddle.to_tensor(b))
    with torch.no_grad():
        tg.gate.weight.copy_(torch.from_numpy(w.T.copy()))
        tg.gate.bias.copy_(torch.from_numpy(b))
    return jg, tg


def _tokens(T, seed=1):
    return np.random.RandomState(seed).standard_normal((T, M)).astype(
        np.float32)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("kind,zero", [("naive", False), ("switch", False),
                                       ("gshard", False), ("gshard", True),
                                       ("naive", True)])
def test_gates_route_like_jax(monkeypatch, kind, zero, training):
    """ids, slots and keep exact; w and aux within 1e-6.  Zero gate
    weights make every probability 1/E: the lower expert index must win
    each tie, so every token routes to experts 0 and 1, and most drop."""
    jg, tg = _gate_pair(kind, zero)
    jg.train() if training else jg.eval()
    tg.train(training)
    _inject(monkeypatch, 3, [tg])
    x = _tokens(64)
    want = jg.forward_indices(paddle.to_tensor(x))
    got = tg.forward_indices(torch.from_numpy(x))
    assert got[4] == want[4]                                   # capacity
    for i in range(3):                                         # eid/slot/keep
        np.testing.assert_array_equal(got[i].numpy(), _np(want[i]))
    for i in (3, 5):                                           # w, aux
        np.testing.assert_allclose(got[i].detach().numpy(), _np(want[i]),
                                   atol=1e-6, rtol=0)
    keep = got[2].numpy()
    if training or zero or kind != "gshard":   # GShard's eval capacity 2.4
        assert 0 < keep.sum() < keep.size                      # drops occur
    if zero:
        assert set(got[0][:, 0].tolist()) == {0}
        if got[0].shape[1] > 1:
            assert set(got[0][:, 1].tolist()) == {1}


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("kind,zero,skew", [("naive", False, 0.0),
                                            ("switch", False, 1.5),
                                            ("gshard", False, 1.5),
                                            ("gshard", True, 0.0)])
def test_gate_forward_is_the_jax_dense_route(monkeypatch, kind, zero, skew,
                                             training):
    """``forward``'s ``(T, E, C)`` combine and dispatch equal the JAX
    gates' (drops counted into the second choice's offsets, GShard's
    random keep on the same uniforms, the kept weights renormalised), and
    say the same as the index form: each kept choice's weight at its
    slot."""
    jg, tg = _gate_pair(kind, zero, skew=skew)
    jg.train() if training else jg.eval()
    tg.train(training)
    _inject(monkeypatch, 4, [tg])
    x = _tokens(64, seed=2)
    jc, jd, jaux = jg(paddle.to_tensor(x))
    tc, td, taux = tg(torch.from_numpy(x))
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tc.detach().numpy(), _np(jc), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux.item()), atol=1e-6)
    assert tg.get_loss() is taux
    _inject(monkeypatch, 4, [tg])
    eid, slot, keep, w, cap, _ = tg.forward_indices(torch.from_numpy(x))
    assert tc.shape == (64, E, cap)
    dense = torch.zeros_like(tc)
    for j in range(eid.shape[1]):
        dense[torch.arange(64), eid[:, j], slot[:, j]] += w[:, j] * keep[:, j]
    torch.testing.assert_close(tc.detach(), dense.detach(), atol=1e-6,
                               rtol=0)


def _positional_gate_pair(kind, world_size):
    """The JAX gate and the port's built positionally, ``world_size``
    third (the JAX order), with the same weights."""
    paddle.seed(5)
    if kind == "naive":
        jg = jmoe.NaiveGate(M, E, world_size, 2, 1.0)
        tg = tmoe.NaiveGate(M, E, world_size, 2, 1.0)
    elif kind == "switch":
        jg = jmoe.SwitchGate(M, E, world_size, 1, 1.0, 4, None)
        tg = tmoe.SwitchGate(M, E, world_size, 1, 1.0, 4, None)
    else:
        rr = kind == "gshard"
        jg = jmoe.GShardGate(M, E, world_size, 2, (1.2, 2.4), rr, None)
        tg = tmoe.GShardGate(M, E, world_size, 2, (1.2, 2.4), rr, None)
    w, b = _np(jg.gate.weight).copy(), _np(jg.gate.bias).copy()
    with torch.no_grad():
        tg.gate.weight.copy_(torch.from_numpy(w.T.copy()))
        tg.gate.bias.copy_(torch.from_numpy(b))
    return jg, tg


@pytest.mark.parametrize("kind", ["naive", "switch", "gshard",
                                  "gshard_no_random_routing"])
def test_gates_take_world_size_third_like_jax(monkeypatch, kind):
    """``NaiveGate(M, E, 2, ...)`` routes over ``2 E`` experts in both
    packages: the Linear is ``M -> 2 E``, ids, slots and keep equal, the
    weights and the aux loss (which counts ``2 E``) within 1e-6, in
    training.  ``random_routing=False`` draws no uniforms and keeps every
    second choice within capacity, as the JAX gate does."""
    jg, tg = _positional_gate_pair(kind, 2)
    assert tg.tot_expert == jg.tot_expert == 2 * E
    assert tuple(tg.gate.weight.shape) == (2 * E, M)
    jg.train()
    tg.train()
    if kind == "gshard_no_random_routing":
        def never(*a, **k):
            raise AssertionError("random routing is off")
        monkeypatch.setattr(paddle, "rand", never)
        monkeypatch.setattr(tg, "uniforms", never)
    else:
        _inject(monkeypatch, 6, [tg])
    x = _tokens(64, seed=7)
    want = jg.forward_indices(paddle.to_tensor(x))
    got = tg.forward_indices(torch.from_numpy(x))
    assert got[4] == want[4]
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), _np(want[i]))
    for i in (3, 5):
        np.testing.assert_allclose(got[i].detach().numpy(), _np(want[i]),
                                   atol=1e-6, rtol=0)
    assert int(got[0].max()) >= E          # experts past num_expert routed
    if kind == "gshard":
        _inject(monkeypatch, 6, [tg])
    jc, jd, jaux = jg(paddle.to_tensor(x))
    tc, td, taux = tg(torch.from_numpy(x))
    assert tc.shape[1] == 2 * E
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(taux.item(), float(jaux.item()), atol=1e-6)


def test_moe_layer_takes_the_jax_groups():
    """``MoELayer``'s ``moe_group`` and ``mp_group`` come after
    ``capacity_factor``, as in the JAX layer, and change nothing."""
    a = tmoe.MoELayer(M, None, "switch", E, H, 1, 1.0, None, None,
                      device="cpu")
    b = tmoe.MoELayer(M, gate="switch", num_expert=E, d_hidden=H, top_k=1,
                      capacity_factor=1.0, device="cpu")
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(_tokens(16))
    torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)


def test_routing_indices_match_jax(monkeypatch):
    jg, tg = _gate_pair("gshard", skew=1.5)
    _inject(monkeypatch, 4, [tg])
    x = _tokens(48, seed=2)
    eid, slot, keep, _, cap, _ = jg.forward_indices(paddle.to_tensor(x))
    want = jpm.routing_indices(_np(eid), _np(slot), _np(keep), E, cap)
    got = tops.routing_indices(*(torch.from_numpy(_np(a).copy())
                                 for a in (eid, slot, keep)), E, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert (got[1] == 48).any() and (got[0] == E * cap).any()


# ---------------------------------------------------------------- kernels

def _routing_case(T=40, seed=5):
    """A GShard routing with drops and empty slots, and the matching
    dispatch/combine inputs."""
    rng = np.random.RandomState(seed)
    _, tg = _gate_pair("gshard", seed=seed, skew=1.5)
    tg.eval()
    eid, slot, keep, w, cap, _ = tg.forward_indices(
        torch.from_numpy(rng.standard_normal((T, M)).astype(np.float32)))
    flat, inv = tops.routing_indices(eid, slot, keep, E, cap)
    assert (flat == E * cap).any() and (inv == T).any()
    x = rng.standard_normal((T, M)).astype(np.float32)
    rows = rng.standard_normal((E * cap, M)).astype(np.float32)
    return x, rows, w.detach().numpy(), flat.numpy(), inv.numpy(), cap


def test_dispatch_and_combine_match_the_jax_kernels(pallas_moe):
    x, rows, w, flat, inv, cap = _routing_case()
    got = tops.moe_dispatch(torch.from_numpy(x), torch.from_numpy(inv))
    want = jpm.moe_dispatch(jnp.asarray(x), jnp.asarray(inv),
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert not got[torch.from_numpy(inv) == x.shape[0]].any()
    got = tops.moe_combine(torch.from_numpy(rows), torch.from_numpy(w),
                           torch.from_numpy(flat))
    want = jpm.moe_combine(jnp.asarray(rows), jnp.asarray(w),
                           jnp.asarray(flat), interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)
    # bf16 rows: float32 sums rounded once, as the plain fp32 result
    got16 = tops.moe_combine(torch.from_numpy(rows).bfloat16(),
                             torch.from_numpy(w), torch.from_numpy(flat))
    want16 = tops.moe_combine_reference(
        torch.from_numpy(rows).bfloat16().float(), torch.from_numpy(w),
        torch.from_numpy(flat)).bfloat16()
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, want16)


def test_dispatch_and_combine_grads_match_jax_vjp(pallas_moe):
    x, rows, w, flat, inv, _ = _routing_case(seed=6)
    rng = np.random.RandomState(7)
    g_rows = rng.standard_normal(rows.shape).astype(np.float32)
    # dw sums M products: a cotangent of scale 0.1 keeps it near 1, where
    # fp32 rounding in either summation order stays under the 1e-6 bound
    g_out = 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jpm.moe_dispatch(a, jnp.asarray(inv),
                                                interpret=True),
                     jnp.asarray(x))
    want_dx, = vjp(jnp.asarray(g_rows))
    _, vjp = jax.vjp(lambda r, ww: jpm.moe_combine(r, ww, jnp.asarray(flat),
                                                   interpret=True),
                     jnp.asarray(rows), jnp.asarray(w))
    want_drows, want_dw = vjp(jnp.asarray(g_out))

    tx = torch.from_numpy(x).requires_grad_()
    tops.moe_dispatch(tx, torch.from_numpy(inv)).backward(
        torch.from_numpy(g_rows))
    np.testing.assert_allclose(tx.grad.numpy(), _np(want_dx), atol=1e-6,
                               rtol=0)
    tr = torch.from_numpy(rows).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tops.moe_combine(tr, tw, torch.from_numpy(flat)).backward(
        torch.from_numpy(g_out))
    np.testing.assert_allclose(tr.grad.numpy(), _np(want_drows), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), _np(want_dw), atol=1e-6,
                               rtol=0)
    # a dropped choice's weight gets no gradient, an empty slot's row none
    assert not tw.grad[torch.from_numpy(flat) == rows.shape[0]].any()
    filled = np.zeros(rows.shape[0], bool)
    filled[flat[flat < rows.shape[0]]] = True
    assert not tr.grad[torch.from_numpy(~filled)].any()


def test_every_choice_dropped_gives_zeros():
    T, EC = 5, 8
    flat = torch.full((T, 2), EC, dtype=torch.int32)
    inv = torch.full((EC,), T, dtype=torch.int32)
    x = torch.randn(T, M)
    assert not tops.moe_dispatch(x, inv).any()
    assert not tops.moe_combine(torch.randn(EC, M), torch.zeros(T, 2),
                                flat).any()


class _StubLibrary:
    def __init__(self):
        self.calls = []

    def ptt_moe_dispatch(self, *args):
        self.calls.append("moe_dispatch")
        return 0

    def ptt_moe_combine(self, *args):
        self.calls.append("moe_combine")
        return 0


def test_non_cpu_tensors_launch_the_kernels_and_count(monkeypatch):
    """A tensor off the CPU goes to the kernel library (a stub here),
    counts one launch, and never reaches the plain version; the wrappers
    refuse what the kernels do not take."""
    lib = _StubLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)

    def plain(*a):
        raise AssertionError("the plain version ran on a non-CPU tensor")
    monkeypatch.setattr(tops, "moe_dispatch_reference", plain)
    monkeypatch.setattr(tops, "moe_combine_reference", plain)
    m = dict(device="meta")
    x = torch.empty(16, 64, **m)
    inv = torch.empty(24, dtype=torch.int32, **m)
    w = torch.empty(16, 2, **m)
    flat = torch.empty(16, 2, dtype=torch.int32, **m)
    nd, nc = tops.moe_dispatch.launches, tops.moe_combine.launches
    assert tops.moe_dispatch(x, inv).shape == (24, 64)
    assert tops.moe_combine(torch.empty(24, 64, **m), w, flat).shape == \
        (16, 64)
    # through autograd too: the forward is the kernel
    tops.moe_dispatch(x.requires_grad_(), inv)
    tops.moe_combine(torch.empty(24, 64, **m).requires_grad_(), w, flat)
    assert lib.calls == ["moe_dispatch", "moe_combine"] * 2
    assert tops.moe_dispatch.launches == nd + 2
    assert tops.moe_combine.launches == nc + 2
    with pytest.raises(ValueError, match="16-byte"):
        tops.moe_dispatch(torch.empty(16, 6, **m), inv)
    with pytest.raises(ValueError, match="16-byte"):
        tops.moe_combine(torch.empty(24, 12, dtype=torch.bfloat16, **m), w,
                         flat)
    with pytest.raises(TypeError, match="int32"):
        tops.moe_dispatch(x, inv.long())
    with pytest.raises(ValueError, match="contiguous"):
        tops.moe_dispatch(torch.empty(64, 16, **m).t(), inv)
    with pytest.raises(ValueError, match="k = 9"):
        tops.moe_combine(torch.empty(24, 64, **m), torch.empty(16, 9, **m),
                         torch.empty(16, 9, dtype=torch.int32, **m))
    assert tops.moe_dispatch.launches == nd + 2


# ------------------------------------------------------------------ layer

def _layer_state(jl):
    """The JAX layer's parameters in the port's layout (the gate's linear
    weight transposed)."""
    out = {}
    for k, v in jl.state_dict().items():
        a = _np(v).copy()
        out[k] = torch.from_numpy(a.T.copy() if k == "gate.gate.weight"
                                  else a)
    return out


def test_moe_layer_forward_and_grads_match_jax(monkeypatch, pallas_moe):
    paddle.seed(8)
    jl = jmoe.MoELayer(M, num_expert=E, d_hidden=H, gate="gshard")
    tl = tmoe.MoELayer(M, num_expert=E, d_hidden=H, gate="gshard",
                       device="cpu")
    tl.load_state_dict(_layer_state(jl))
    jl.train()
    tl.train()
    _inject(monkeypatch, 9, [tl])
    rng = np.random.RandomState(10)
    x = rng.standard_normal((2, 24, M)).astype(np.float32)
    r = rng.standard_normal((2, 24, M)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx)
    ((jout * paddle.to_tensor(r)).sum() + jl.l_aux).backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tl(tx)
    ((tout * torch.from_numpy(r)).sum() + tl.l_aux).backward()
    np.testing.assert_allclose(tout.detach().numpy(), _np(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tl.l_aux.item(), float(jl.l_aux.item()),
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), atol=1e-5,
                               rtol=0)
    jgrads = {n: _np(p.grad) for n, p in jl.named_parameters()}
    for n, p in tl.named_parameters():
        want = jgrads[n].T if n == "gate.gate.weight" else jgrads[n]
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("training", [True, False])
def test_dense_moe_layer_matches_jax_and_the_fused_path(monkeypatch,
                                                        pallas_moe,
                                                        training):
    """``MoELayer(fused=False)`` against the JAX layer under
    ``FLAGS_moe_fused_dispatch=0`` (its einsum path), and against the
    port's fused path on the same uniforms: outputs, ``l_aux``, the
    input's and every parameter's gradient."""
    paddle.seed(12)
    with flag_guard(moe_fused_dispatch=False):
        jl = jmoe.MoELayer(M, num_expert=E, d_hidden=H, gate="gshard")
    assert not jl._fused
    dense = tmoe.MoELayer(M, num_expert=E, d_hidden=H, gate="gshard",
                          device="cpu", fused=False)
    fused = tmoe.MoELayer(M, num_expert=E, d_hidden=H, gate="gshard",
                          device="cpu")
    assert not dense.fused and fused.fused
    for tl in (dense, fused):
        tl.load_state_dict(_layer_state(jl))
        tl.train(training)
    jl.train() if training else jl.eval()
    rng = np.random.RandomState(13)
    x = rng.standard_normal((2, 24, M)).astype(np.float32)
    r = rng.standard_normal((2, 24, M)).astype(np.float32)
    _inject(monkeypatch, 14, [dense])
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx)
    ((jout * paddle.to_tensor(r)).sum() + jl.l_aux).backward()
    want = [_np(jout), np.float32(jl.l_aux.item()), _np(jx.grad)]
    jgrads = {n: _np(p.grad) for n, p in jl.named_parameters()}
    for tl in (dense, fused):
        _inject(monkeypatch, 14, [tl])
        n = (tops.moe_dispatch.launches, tops.moe_combine.launches)
        tx = torch.from_numpy(x).requires_grad_()
        tout = tl(tx)
        ((tout * torch.from_numpy(r)).sum() + tl.l_aux).backward()
        for got, w in zip([tout.detach().numpy(), tl.l_aux.item(),
                           tx.grad.numpy()], want):
            np.testing.assert_allclose(got, w, atol=1e-5, rtol=0)
        for name, p in tl.named_parameters():
            w = jgrads[name].T if name == "gate.gate.weight" \
                else jgrads[name]
            np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-5,
                                       rtol=0, err_msg=name)
    assert (tops.moe_dispatch.launches, tops.moe_combine.launches) == n


def test_gpt_moe_config_picks_the_dense_path():
    """``moe_fused_dispatch=False`` (the JAX flag's name) builds every MoE
    block on the dense path; its loss equals the fused model's."""
    ids, labels = _batch()
    losses = []
    for fused in (True, False):
        tm = GPTForCausalLM(gpt3_tiny(moe_num_experts=4,
                                      moe_fused_dispatch=fused),
                            device="cpu", seed=1).eval()
        assert tm.gpt.blocks[1].mlp.fused == fused
        losses.append(tm.compute_loss(torch.from_numpy(ids),
                                      torch.from_numpy(labels)).item())
    assert abs(losses[0] - losses[1]) < 1e-5


# -------------------------------------------------------------------- GPT

def _gpt_pair(seed=0):
    paddle.seed(seed)
    jm = JaxGPT(jax_tiny(moe_num_experts=4))
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(moe_num_experts=4), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    return jm, tm, state


def _batch(B=2, S=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1024, (B, S)).astype(np.int64),
            rng.randint(0, 1024, (B, S)).astype(np.int64))


@pytest.mark.parametrize("training", [True, False])
def test_gpt_moe_logits_and_loss_match_jax(monkeypatch, pallas_moe,
                                           training):
    jm, tm, _ = _gpt_pair()
    jm.train() if training else jm.eval()
    tm.train(training)
    jax_u, port_u = _inject(monkeypatch, 11, [tm])
    ids, labels = _batch()
    want = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=0)
    jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), float(jl.item()), atol=1e-5,
                               rtol=0)
    aux = tm.gpt.blocks[1].mlp.l_aux
    assert aux.item() > 0
    assert len(jax_u.draws) == len(port_u.draws) == (2 if training else 0)


def test_gpt_moe_adamw_steps_match_jax(monkeypatch, pallas_moe):
    """2 AdamW steps with global-norm clipping and random routing: losses
    within 1e-5, parameters within 1e-5 (the key third of each qkv bias
    within 2 x lr x steps, as in tests/test_torch_train.py)."""
    jm, tm, _ = _gpt_pair(seed=2)
    jm.train()
    tm.train()
    _inject(monkeypatch, 12, [tm])
    ids, labels = _batch(seed=1)
    jopt = joptim.AdamW(learning_rate=1e-4, parameters=jm.parameters(),
                        weight_decay=0.01,
                        grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = toptim.AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                        weight_decay=0.01,
                        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    for _ in range(2):
        jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
        tl.backward()
        topt.step()
        topt.clear_grad()
        assert abs(tl.item() - float(jl.item())) < 1e-5
    state = state_from_numpy({k: _np(v)
                              for k, v in jm.state_dict().items()}, tm)
    Hd = tm.cfg.hidden_size
    for name, p in tm.state_dict().items():
        got, want = p.numpy(), state[name].numpy()
        if name.endswith("qkv.bias"):
            np.testing.assert_allclose(got[Hd:2 * Hd], want[Hd:2 * Hd],
                                       atol=2 * 2e-4, rtol=0, err_msg=name)
            got = np.concatenate([got[:Hd], got[2 * Hd:]])
            want = np.concatenate([want[:Hd], want[2 * Hd:]])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_convert_carries_moe_weights_and_moments(pallas_moe):
    """The gate's linear weight (and its moments) transposed, the stacked
    expert weights as they are; one JAX step's AdamW state loads into the
    port's optimizer."""
    jm, tm, state = _gpt_pair(seed=3)
    sd = tm.state_dict()
    assert set(sd) == set(state)
    gate_w = "gpt.blocks.1.mlp.gate.gate.weight"
    np.testing.assert_array_equal(sd[gate_w].numpy(), state[gate_w].T)
    for part in ("w1", "b1", "w2", "b2"):
        name = f"gpt.blocks.1.mlp.experts.{part}"
        np.testing.assert_array_equal(sd[name].numpy(), state[name])
    jm.train()
    ids, labels = _batch(S=16, seed=2)
    jopt = joptim.AdamW(learning_rate=1e-4, parameters=jm.parameters(),
                        weight_decay=0.01)
    jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels)) \
        .backward()
    jopt.step()
    jsd = jopt.remap_state_keys(jm, jopt.state_dict(), to_structured=True)
    jsd = {k: (_np(v) if hasattr(v, "_value") else v) for k, v in
           jsd.items()}
    topt = toptim.AdamW(learning_rate=1e-4, parameters=tm.named_parameters(),
                        weight_decay=0.01)
    topt.set_state_dict(adamw_state_from_numpy(jsd, tm))
    got = topt.state_dict()
    for key in (f"{gate_w}@moment1", f"{gate_w}@moment2"):
        np.testing.assert_array_equal(got[key].numpy(), jsd[key].T)
    w1 = "gpt.blocks.1.mlp.experts.w1@moment1"
    np.testing.assert_array_equal(got[w1].numpy(), jsd[w1])


# ---------------------------------------------------------------- serving

PROMPT_LENS = (29, 11, 40)
BUDGETS = (8, 6, 5)
ENGINE = dict(max_batch=2, max_context=64, block_size=16, steps_per_tick=4)


@pytest.mark.parametrize("chunk", [0, 16])
def test_moe_serving_streams_match_the_jax_engine(pallas_moe, chunk):
    """Greedy streams equal: the engines feed the gate the same pad rows
    (a prompt's bucket padding, the idle decode slots), which compete for
    expert capacity."""
    jm, tm, _ = _gpt_pair(seed=4)
    jm.eval()
    tm.eval()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 1024, (n,)).tolist() for n in PROMPT_LENS]
    with flag_guard(serving_pallas_prefill=False):
        jeng = JaxEngine(jm, prefill_chunk=chunk, prefix_cache=False,
                         **ENGINE)
        jreqs = [jeng.add_request(JaxRequest(p, max_new_tokens=b))
                 for p, b in zip(prompts, BUDGETS)]
        jeng.run()
    want = [list(r.output_ids) for r in jreqs]
    eng = ServingEngine(tm, device="cpu", prefill_chunk=chunk, **ENGINE)
    reqs = [eng.add_request(Request(p, max_new_tokens=b))
            for p, b in zip(prompts, BUDGETS)]
    eng.run()
    got = [list(r.output_ids) for r in reqs]
    assert got == want
    assert [len(s) for s in got] == list(BUDGETS)


def test_serving_refuses_an_moe_model_in_training_mode():
    """In training mode the gates route at random at the training
    capacity, so greedy streams would not be reproducible: the engine
    refuses, at construction and at every step."""
    tm = GPTForCausalLM(gpt3_tiny(moe_num_experts=4), device="cpu", seed=1)
    with pytest.raises(ValueError, match="eval mode"):
        ServingEngine(tm, device="cpu", **ENGINE)
    tm.eval()
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    req = eng.add_request(Request([1, 2, 3], max_new_tokens=2))
    tm.train()
    with pytest.raises(ValueError, match="eval mode"):
        eng.step()
    tm.eval()
    eng.run()
    assert len(req.output_ids) == 2
    # a dense model has no routing to protect: served in either mode
    ServingEngine(GPTForCausalLM(gpt3_tiny(), device="cpu"), device="cpu",
                  **ENGINE)
