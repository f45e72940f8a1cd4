"""The port's schedulers, optimizers and fused step against the JAX
package's, on the CPU.

The same numpy parameters and gradients go to both packages.  Tolerances:

- learning-rate schedules: exactly equal (the schedulers are the same
  pure Python), also across a ``state_dict`` round trip;
- the nine optimizers and LBFGS: parameters and accumulators after three
  steps within atol 1e-6 in float32 (both packages round the same
  float32 operations, in other orders); bfloat16 parameters
  (``multi_precision``) within one bf16 step (rtol 2^-7: masters 1e-6
  apart may round to neighbours), their float32 masters within 1e-6;
- the fused step with a GradScaler: the scale, good and bad counts and
  the step count exactly equal after every step, parameters within 1e-6;
- the ``optimizer.fused`` counter: hit, miss and fallback counts equal
  where both packages take the same path.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu import regularizer as jreg
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.models.convert import (optimizer_state_from_numpy,
                                             state_from_numpy)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = [(4, 5), (7,), (3, 2, 2), (9,)]


# ------------------------------------------------------------ schedulers

def _sched(mod, name):
    """One instance of each scheduler, the same arguments in both
    packages."""
    lam = (lambda e: 0.95 ** e)
    return {
        "NoamDecay": lambda: mod.NoamDecay(64, 10, learning_rate=2.0),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.5, 0.9),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.5, 0.1),
        "PolynomialDecay": lambda: mod.PolynomialDecay(0.5, 12, 0.01, 2.0),
        "PolynomialDecay_cycle": lambda: mod.PolynomialDecay(
            0.5, 7, 0.01, 1.5, cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(0.3, 5, 0.0, 0.3),
        "LinearWarmup_cosine": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.3, 20, 0.01), 5, 0.0, 0.3),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay([4, 9, 17],
                                                     [1.0, 0.5, 0.1, 0.01]),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(0.3, 11,
                                                                 0.02),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.4, [3, 8, 20], 0.3),
        "StepDecay": lambda: mod.StepDecay(0.4, 4, 0.5),
        "LambdaDecay": lambda: mod.LambdaDecay(0.4, lam),
        "MultiplicativeDecay": lambda: mod.MultiplicativeDecay(0.4, lam),
        "ReduceOnPlateau": lambda: mod.ReduceOnPlateau(
            0.4, patience=2, cooldown=1, factor=0.5, min_lr=0.01),
        "OneCycleLR": lambda: mod.OneCycleLR(0.5, 25, phase_pct=0.3),
        "CyclicLR": lambda: mod.CyclicLR(0.01, 0.2, 4, mode="triangular2"),
        "CyclicLR_exp": lambda: mod.CyclicLR(0.01, 0.2, 3, 5,
                                             mode="exp_range",
                                             exp_gamma=0.97),
        "LinearLR": lambda: mod.LinearLR(0.4, 12, 0.2, 1.0),
        "CosineAnnealingWarmRestarts": lambda:
            mod.CosineAnnealingWarmRestarts(0.3, 4, 2, 0.01),
    }[name]()


SCHEDULES = ["NoamDecay", "ExponentialDecay", "NaturalExpDecay",
             "InverseTimeDecay", "PolynomialDecay", "PolynomialDecay_cycle",
             "LinearWarmup", "LinearWarmup_cosine", "PiecewiseDecay",
             "CosineAnnealingDecay", "MultiStepDecay", "StepDecay",
             "LambdaDecay", "MultiplicativeDecay", "ReduceOnPlateau",
             "OneCycleLR", "CyclicLR", "CyclicLR_exp", "LinearLR",
             "CosineAnnealingWarmRestarts"]
# ReduceOnPlateau's metric: falls, then stalls, then falls again
_METRICS = [1.0, 0.8, 0.7, 0.7, 0.71, 0.72, 0.7, 0.69, 0.7, 0.7, 0.71,
            0.5, 0.5, 0.5, 0.5, 0.5, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.3,
            0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]


def _advance(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(_METRICS[i])
    else:
        s.step()


@pytest.mark.parametrize("name", SCHEDULES)
def test_scheduler_rates_equal_jax_over_30_steps(name):
    """30 steps, every rate bit for bit; at step 15 each package's
    state_dict (equal) goes into a fresh scheduler of its own, and the two
    go on to the same rates."""
    j, t = _sched(jlr, name), _sched(tlr, name)
    rates = []
    for i in range(30):
        assert t() == j(), (name, i)
        rates.append(t())
        if i == 15:
            # both round trips (a LinearWarmup's state leaves out the
            # scheduler it wraps, in both packages)
            sd = t.state_dict()
            assert sd == j.state_dict()
            t, j2 = _sched(tlr, name), _sched(jlr, name)
            t.set_state_dict(sd)
            j2.set_state_dict(j.state_dict())
            j = j2
        _advance(j, i)
        _advance(t, i)
    assert len(set(rates)) > 1 or name == "ReduceOnPlateau"


def test_a_scheduler_subclass_runs_like_jax():
    """``LRScheduler`` itself: a subclass's ``get_lr`` and ``step(epoch)``
    behave alike."""
    def make(mod):
        class Halving(mod.LRScheduler):
            def get_lr(self):
                return self.base_lr / 2 ** self.last_epoch
        return Halving(0.8)
    j, t = make(jlr), make(tlr)
    for epoch in (None, None, 5, None, 2):
        j.step(epoch)
        t.step(epoch)
        assert t() == j() and t.last_epoch == j.last_epoch
    with pytest.raises(NotImplementedError):
        tlr.LRScheduler(0.1)


# ------------------------------------------------------------ optimizers

def _params(dtype="float32", seed=0):
    rng = np.random.RandomState(seed)
    vals = [rng.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]
    jp = [paddle.Parameter(v) for v in vals]
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    if dtype == "bfloat16":
        for p in jp:
            p._value = p._value.astype("bfloat16")
        tp = [torch.nn.Parameter(p.detach().bfloat16()) for p in tp]
    return jp, tp


def _grads(step, seed=0, scale=1.0, inf_at=None):
    rng = np.random.RandomState(seed * 1000 + step)
    gs = [rng.uniform(-1, 1, s).astype(np.float32) * scale for s in SHAPES]
    if inf_at == step:
        gs[2].flat[3] = np.inf
    return gs


def _set_grads(jp, tp, gs):
    for j, t, g in zip(jp, tp, gs):
        jg = paddle.to_tensor(g)
        if j._value.dtype != jg._value.dtype:
            jg = jg.astype(str(j._value.dtype))
        j.grad = jg
        t.grad = torch.from_numpy(g.copy()).to(t.dtype)


def _names(tp):
    return [f"w{i}" for i in range(len(tp))]


OPTIMIZERS = {
    "SGD": (dict(learning_rate=0.1, weight_decay=0.01), {}),
    "Momentum": (dict(learning_rate=0.05, momentum=0.9, use_nesterov=True,
                      weight_decay="L2"), {}),
    "Adam": (dict(learning_rate=0.01, weight_decay="L1"), {}),
    "AdamW": (dict(learning_rate=0.01, weight_decay=0.02,
                   apply_decay_param_fun="odd"), {}),
    "Adagrad": (dict(learning_rate=0.1, weight_decay=0.01), {}),
    "RMSProp": (dict(learning_rate=0.01, momentum=0.5, centered=True), {}),
    "Adadelta": (dict(learning_rate=1.0, weight_decay="L2"), {}),
    "Adamax": (dict(learning_rate=0.02), {}),
    "Lamb": (dict(learning_rate=0.02, exclude_from_weight_decay_fn="odd"),
             {}),
}


def _kwargs(kw, mod, reg, names):
    """Resolve the placeholders: "L1"/"L2" decays, the "odd" name
    predicates (by the port's names, mapped for JAX parameters)."""
    out = dict(kw)
    if out.get("weight_decay") == "L2":
        out["weight_decay"] = reg.L2Decay(0.01)
    if out.get("weight_decay") == "L1":
        out["weight_decay"] = reg.L1Decay(0.001)
    for key in ("apply_decay_param_fun", "exclude_from_weight_decay_fn"):
        if out.get(key) == "odd":
            out[key] = (lambda n, names=names: names(n) % 2 == 1) \
                if key == "apply_decay_param_fun" else \
                (lambda n, names=names: names(n) % 2 == 0)
    return out


def _build(name, kw, jp, tp, multi_precision=False, lr=None, groups=False,
           clip=None):
    jidx = {p.name: i for i, p in enumerate(jp)}
    tnames = _names(tp)
    jkw = _kwargs(kw, jreg, jreg, lambda n: jidx[n])
    tkw = _kwargs(kw, treg, treg, lambda n: int(n[1:]))
    if name == "Lamb":
        # the JAX package hands the parameter, the port its name
        fn = jkw["exclude_from_weight_decay_fn"]
        jkw["exclude_from_weight_decay_fn"] = lambda p, fn=fn: fn(p.name)
    if lr is not None:
        jkw["learning_rate"], tkw["learning_rate"] = lr
    if multi_precision:
        jkw["multi_precision"] = tkw["multi_precision"] = True
    if clip is not None:
        jkw["grad_clip"], tkw["grad_clip"] = clip
    jparams = jp
    tparams = list(zip(tnames, tp))
    if groups:
        jparams = [{"params": jp[:2], "learning_rate": 0.5},
                   {"params": jp[2:], "weight_decay": 0.05}]
        tparams = [{"params": tparams[:2], "learning_rate": 0.5},
                   {"params": tparams[2:], "weight_decay": 0.05}]
    return (getattr(joptim, name)(parameters=jparams, **jkw),
            getattr(toptim, name)(parameters=tparams, **tkw))


def _assert_states_match(jopt, topt, jp, tp, atol=1e-6):
    names = _names(tp)
    for i, (j, t) in enumerate(zip(jp, tp)):
        want = np.asarray(j._value.astype("float32"))
        if t.dtype == torch.bfloat16:
            np.testing.assert_allclose(t.detach().float().numpy(), want,
                                       atol=atol, rtol=2 ** -7)
        else:
            np.testing.assert_allclose(t.detach().numpy(), want, atol=atol,
                                       rtol=0, err_msg=names[i])
    for acc, store in jopt._accumulators.items():
        for i, j in enumerate(jp):
            if id(j) not in store:
                continue
            got = topt._accumulators[acc][names[i]]
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(store[id(j)], np.float32),
                atol=atol, rtol=0, err_msg=f"{names[i]}@{acc}")
    assert topt._global_step == jopt._global_step


def _run(jopt, topt, jp, tp, steps=3, scheds=None):
    for s in range(steps):
        _set_grads(jp, tp, _grads(s))
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        if scheds:
            for sc in scheds:
                sc.step()


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    kw, _ = OPTIMIZERS[name]
    jp, tp = _params()
    jopt, topt = _build(name, kw, jp, tp)
    _run(jopt, topt, jp, tp)
    _assert_states_match(jopt, topt, jp, tp)


@pytest.mark.parametrize("name", ["SGD", "Adam", "RMSProp", "Lamb"])
def test_optimizer_groups_match_jax(name):
    """Two groups: a learning-rate ratio on one, its own decay on the
    other; a parameter's ``optimize_attr`` learning rate on top."""
    kw, _ = OPTIMIZERS[name]
    kw = {k: v for k, v in kw.items() if k != "weight_decay"}
    jp, tp = _params(seed=1)
    jp[3].optimize_attr["learning_rate"] = 0.25
    tp[3].optimize_attr = {"learning_rate": 0.25}
    jopt, topt = _build(name, kw, jp, tp, groups=True)
    _run(jopt, topt, jp, tp)
    _assert_states_match(jopt, topt, jp, tp)


@pytest.mark.parametrize("name", ["AdamW", "Momentum", "Adagrad"])
def test_a_scheduler_as_the_learning_rate_matches_jax(name):
    kw, _ = OPTIMIZERS[name]
    jp, tp = _params(seed=2)
    js = jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.05, 10), 2, 0.0, 0.05)
    ts = tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.05, 10), 2, 0.0, 0.05)
    jopt, topt = _build(name, kw, jp, tp, lr=(js, ts))
    _run(jopt, topt, jp, tp, steps=4, scheds=(js, ts))
    assert topt.get_lr() == jopt.get_lr()
    with pytest.raises(RuntimeError):
        topt.set_lr(0.1)
    _assert_states_match(jopt, topt, jp, tp)
    assert topt.state_dict()["LR_Scheduler"] == \
        jopt.state_dict()["LR_Scheduler"]


@pytest.mark.parametrize("name", ["AdamW", "Momentum", "SGD", "RMSProp"])
def test_multi_precision_matches_jax(name):
    """bfloat16 parameters with float32 masters: the masters within 1e-6,
    the bf16 copies within one bf16 rounding."""
    kw, _ = OPTIMIZERS[name]
    jp, tp = _params("bfloat16", seed=3)
    jopt, topt = _build(name, kw, jp, tp, multi_precision=True)
    _run(jopt, topt, jp, tp)
    _assert_states_match(jopt, topt, jp, tp)
    assert set(topt._accumulators["master_weight"]) == set(_names(tp))


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    """A least-squares problem: one ``step(closure)`` of up to 6
    iterations."""
    rng = np.random.RandomState(4)
    A = rng.standard_normal((12, 5)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    x0 = rng.standard_normal(5).astype(np.float32) * 0.1
    jx = paddle.Parameter(x0.copy())
    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    jopt = joptim.LBFGS(learning_rate=0.5, max_iter=6, history_size=4,
                        line_search_fn=line_search, parameters=[jx])
    topt = toptim.LBFGS(learning_rate=0.5, max_iter=6, history_size=4,
                        line_search_fn=line_search, parameters=[tx])
    jA, jb = paddle.to_tensor(A), paddle.to_tensor(b)
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)

    def jclosure():
        jopt.clear_grad()
        r = paddle.matmul(jA, jx) - jb
        loss = (r * r).sum()
        loss.backward()
        return loss

    def tclosure():
        topt.clear_grad()
        loss = ((tA @ tx - tb) ** 2).sum()
        loss.backward()
        return loss
    jf = jopt.step(jclosure)
    tf = topt.step(tclosure)
    assert abs(jf - tf) < 1e-5
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx._value),
                               atol=1e-5, rtol=0)
    assert topt._global_step == jopt._global_step == 1
    with pytest.raises(RuntimeError, match="closure"):
        topt.step()


def test_l1_and_l2_regularizers_are_the_jax_ones():
    assert repr(treg.L2Decay(0.5)) == repr(jreg.L2Decay(0.5))
    assert repr(treg.L1Decay(0.5)) == repr(jreg.L1Decay(0.5))
    jp, tp = _params(seed=5)
    jopt, topt = _build("SGD", dict(learning_rate=0.1,
                                    weight_decay="L1"), jp, tp)
    _run(jopt, topt, jp, tp, steps=2)
    _assert_states_match(jopt, topt, jp, tp)


# ---------------------------------------------------------- fused path

@pytest.fixture
def counters():
    """Both registries on and from 0; the ``optimizer.fused`` counts as
    (port, JAX) readers."""
    jmetrics.reset()
    tmetrics.reset()

    def read(kind):
        t = tmetrics.get("optimizer.fused")
        j = jmetrics.get("optimizer.fused")
        return (t.value(kind=kind) if t else 0,
                j.value(kind=kind) if j else 0)
    yield read
    jmetrics.reset()
    tmetrics.reset()


def _clip(kind):
    return {None: (None, None),
            "global": (jnn.ClipGradByGlobalNorm(0.8),
                       tnn.ClipGradByGlobalNorm(0.8)),
            "norm": (jnn.ClipGradByNorm(0.5), tnn.ClipGradByNorm(0.5)),
            "value": (jnn.ClipGradByValue(0.3, -0.2),
                      tnn.ClipGradByValue(0.3, -0.2))}[kind]


@pytest.mark.parametrize("clip", [None, "global", "norm", "value"])
@pytest.mark.parametrize("inf_at", [None, 1, 2])
def test_fused_scaler_step_matches_the_jax_program(counters, clip, inf_at):
    """AdamW under a dynamic GradScaler (x2 every 2 good steps, /2 on an
    overflow) over 5 steps, one parameter outside the clip
    (``need_clip``) and one at half the learning rate: after every step
    the scale, good and bad counts and the applied-step count equal the
    JAX program's exactly, parameters and moments within 1e-6; an
    overflow step changes nothing but the scaler."""
    jp, tp = _params(seed=6)
    jp[1].need_clip = False
    tp[1].need_clip = False
    jp[2].optimize_attr["learning_rate"] = 0.5
    tp[2].optimize_attr = {"learning_rate": 0.5}
    jopt, topt = _build("AdamW", dict(learning_rate=0.01, weight_decay=0.02),
                        jp, tp, clip=_clip(clip))
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    for s in range(5):
        gs = _grads(s, seed=7, inf_at=inf_at)
        scale = ts._scale
        assert scale == js._scale
        _set_grads(jp, tp, [g * scale for g in gs])
        before = [t.detach().clone() for t in tp]
        js.step(jopt)
        ts.step(topt)
        assert (ts._scale, ts._good_steps, ts._bad_steps, ts._found_inf) \
            == (js._scale, js._good_steps, js._bad_steps, js._found_inf)
        _assert_states_match(jopt, topt, jp, tp)
        if s == inf_at:
            assert all(torch.equal(a, b) for a, b in zip(before, tp))
        jopt.clear_grad()
        topt.clear_grad()
    assert counters("fallback") == (0, 0)
    assert counters("miss")[0] >= 1
    assert sum(counters("hit")) + sum(counters("miss")) == 10


def test_fused_step_without_a_scaler_matches_jax(counters):
    """Plain steps: one table built, then reused, as the JAX program is
    traced once and then hit."""
    jp, tp = _params(seed=8)
    jopt, topt = _build("AdamW", dict(learning_rate=0.01), jp, tp,
                        clip=_clip("global"))
    _run(jopt, topt, jp, tp, steps=4)
    _assert_states_match(jopt, topt, jp, tp)
    assert counters("miss") == (1, 1)
    assert counters("hit") == (3, 3)
    assert counters("fallback") == (0, 0)


def test_fused_fallbacks_are_the_jax_ones(counters):
    """L1 decay and a subclass of a clip class fall back in both
    packages, once a step; RMSProp, which the JAX program runs and the
    port's kernel does not carry, falls back in the port alone."""
    jp, tp = _params(seed=9)
    jopt, topt = _build("Adam", OPTIMIZERS["Adam"][0], jp, tp)    # L1
    _run(jopt, topt, jp, tp, steps=2)
    assert counters("fallback") == (2, 2)

    class JClip(jnn.ClipGradByGlobalNorm):
        pass

    class TClip(tnn.ClipGradByGlobalNorm):
        pass
    jp, tp = _params(seed=10)
    jopt, topt = _build("AdamW", dict(learning_rate=0.01), jp, tp,
                        clip=(JClip(1.0), TClip(1.0)))
    _run(jopt, topt, jp, tp, steps=2)
    _assert_states_match(jopt, topt, jp, tp)
    assert counters("fallback") == (4, 4)
    jp, tp = _params(seed=11)
    jopt, topt = _build("RMSProp", OPTIMIZERS["RMSProp"][0], jp, tp)
    _run(jopt, topt, jp, tp, steps=2)
    t_fb, j_fb = counters("fallback")
    assert (t_fb, j_fb) == (6, 4)


class _JSubclassClip(jnn.ClipGradByGlobalNorm):
    pass


class _TSubclassClip(tnn.ClipGradByGlobalNorm):
    pass


# ROADMAP §C.8: the routes a step can take, as (optimizer, its arguments,
# the clips of both packages); the clip's norm is below the gradients' so
# that it scales them
GRAD_ROUTES = {
    "fused_global": ("AdamW", dict(learning_rate=0.01, weight_decay=0.02),
                     lambda: (jnn.ClipGradByGlobalNorm(0.05),
                              tnn.ClipGradByGlobalNorm(0.05))),
    "fused_norm": ("Momentum", dict(learning_rate=0.05, momentum=0.9),
                   lambda: (jnn.ClipGradByNorm(0.1),
                            tnn.ClipGradByNorm(0.1))),
    "fused_value": ("SGD", dict(learning_rate=0.1),
                    lambda: (jnn.ClipGradByValue(0.3, -0.2),
                             tnn.ClipGradByValue(0.3, -0.2))),
    "clip_subclass": ("AdamW", dict(learning_rate=0.01),
                      lambda: (_JSubclassClip(0.05), _TSubclassClip(0.05))),
    "l1_decay": ("Adam", dict(learning_rate=0.01, weight_decay="L1"),
                 lambda: (jnn.ClipGradByGlobalNorm(0.05),
                          tnn.ClipGradByGlobalNorm(0.05))),
    "adagrad": ("Adagrad", dict(learning_rate=0.1),
                lambda: (jnn.ClipGradByNorm(0.1), tnn.ClipGradByNorm(0.1))),
}


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaler"])
@pytest.mark.parametrize("route", list(GRAD_ROUTES))
def test_grads_after_a_step_equal_jax(counters, route, scaled):
    """After every step ``p.grad`` equals the JAX package's exactly,
    whichever route the port took (the fused step, or the list rules for
    a clip subclass, L1 decay or Adagrad): without a scaler backward's
    gradients, untouched by the clip; with a GradScaler (scale 1024) the
    unscaled gradients, also on the overflow step (where they hold the
    inf).  Parameters within 1e-6 as elsewhere."""
    name, kw, clips = GRAD_ROUTES[route]
    jp, tp = _params(seed=15)
    jopt, topt = _build(name, kw, jp, tp, clip=clips())
    js = jamp.GradScaler(init_loss_scaling=1024.0) if scaled else None
    ts = tamp.GradScaler(init_loss_scaling=1024.0) if scaled else None
    for s in range(3):
        gs = _grads(s, seed=16, inf_at=1 if scaled else None)
        scale = ts._scale if scaled else 1.0
        _set_grads(jp, tp, [g * scale for g in gs])
        if scaled:
            js.step(jopt)
            ts.step(topt)
        else:
            jopt.step()
            topt.step()
        for i, (j, t) in enumerate(zip(jp, tp)):
            want = np.asarray(j.grad._value)
            np.testing.assert_array_equal(t.grad.numpy(), want,
                                          err_msg=f"{route} step {s} w{i}")
            if not scaled:
                np.testing.assert_array_equal(want, gs[i])
        _assert_states_match(jopt, topt, jp, tp)
        jopt.clear_grad()
        topt.clear_grad()
    fused = route.startswith("fused")
    assert (counters("fallback")[0] == 0) == fused


class _PerTensor:
    """Runs an optimizer's rule one tensor at a time (the base
    ``_rule_many``), whatever the optimizer overrides."""

    def _rule_many(self, *args):
        return toptim.Optimizer._rule_many(self, *args)


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(weight_decay=0.1)),
    ("Momentum", dict(weight_decay=0.1)),
    ("Momentum", dict(use_nesterov=True)),
    ("Adam", dict(weight_decay=0.1)),
    ("AdamW", dict(weight_decay=0.1))])
@pytest.mark.parametrize("dtype,multi_precision", [
    (torch.float32, False), (torch.bfloat16, True), (torch.bfloat16, False)])
def test_declined_steps_run_the_list_rules_bit_for_bit(counters, name, kw,
                                                       dtype,
                                                       multi_precision):
    """A step the fused path declines (here: a subclass of the global
    clip) runs SGD, Momentum and Adam over the whole list in
    ``torch._foreach_*`` calls: parameters, masters and states equal, bit
    for bit, to the same rule applied one tensor at a time, over three
    steps with a decay on every other tensor."""
    class Clip(tnn.ClipGradByGlobalNorm):
        pass
    cls = getattr(toptim, name)
    rng = np.random.RandomState(13)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    runs = []
    for per_tensor in (False, True):
        params = [torch.nn.Parameter(torch.tensor(w).to(dtype))
                  for w in init]
        groups = [{"params": params[::2]},
                  {"params": params[1::2], "weight_decay": 0.0}]
        kind = type("PerTensor" + name, (_PerTensor, cls), {}) \
            if per_tensor else cls
        opt = kind(learning_rate=0.01, parameters=groups,
                   grad_clip=Clip(0.8), multi_precision=multi_precision,
                   **kw)
        g_rng = np.random.RandomState(14)
        for _ in range(3):
            for p in params:
                p.grad = torch.tensor(g_rng.randn(*p.shape)
                                      .astype(np.float32)).to(dtype)
            opt.step()
        runs.append((params, opt._accumulators))
    (pa, sa), (pb, sb) = runs
    assert counters("fallback")[0] == 6
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    assert sorted(sa) == sorted(sb)
    for acc in sa:
        for n in sa[acc]:
            assert torch.equal(sa[acc][n], sb[acc][n]), (acc, n)


# --------------------------------------------------- state carried over

def _gpt_pair(seed):
    paddle.seed(seed)
    jm = JaxGPT(jax_tiny())
    jm.train()
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm))
    tm.train()
    return jm, tm


@pytest.mark.parametrize("name", ["RMSProp", "Momentum", "Adamax"])
def test_optimizer_state_carries_a_jax_run_into_the_port(name):
    """Two JAX steps on the tiny GPT (a StepDecay schedule as the
    learning rate), the weights, every accumulator and the scheduler
    carried over (``optimizer_state_from_numpy``), then one more step in
    each: parameters within 1e-5, but the key third of each qkv bias
    (ROADMAP.md reference fact 6) within 2 lr steps."""
    jm, tm = _gpt_pair(seed=13)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (2, 16))
    kw = {k: v for k, v in OPTIMIZERS[name][0].items()
          if k not in ("weight_decay", "learning_rate")}
    js = jlr.StepDecay(0.01, 2, 0.5)
    jopt = getattr(joptim, name)(learning_rate=js,
                                 parameters=jm.parameters(), **kw)
    for _ in range(2):
        jm.compute_loss(paddle.to_tensor(ids),
                        paddle.to_tensor(ids)).backward()
        jopt.step()
        jopt.clear_grad()
        js.step()
    tm.load_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm))
    jsd = jopt.remap_state_keys(jm, jopt.state_dict(), to_structured=True)
    jsd = {k: (np.asarray(v._value) if hasattr(v, "_value") else v)
           for k, v in jsd.items()}
    ts = tlr.StepDecay(0.01, 2, 0.5)
    topt = getattr(toptim, name)(learning_rate=ts,
                                 parameters=tm.named_parameters(), **kw)
    topt.set_state_dict(optimizer_state_from_numpy(jsd, tm))
    assert topt.state_dict()["global_step"] == 2
    assert ts.last_epoch == js.last_epoch and ts() == js()
    for m, opt in ((jm, jopt), (tm, topt)):
        loss = m.compute_loss(
            *((paddle.to_tensor(ids),) * 2 if m is jm
              else (torch.from_numpy(ids),) * 2))
        loss.backward()
        opt.step()
    state = state_from_numpy(
        {k: np.asarray(v._value) for k, v in jm.state_dict().items()}, tm)
    H = tm.cfg.hidden_size
    for k, v in tm.state_dict().items():
        got, want = v.numpy(), state[k].numpy()
        if k.endswith("qkv.bias"):
            # the key third's gradient is rounding noise (reference fact
            # 6), which Adamax divides by its own size: held to 2 lr steps
            np.testing.assert_allclose(got[H:2 * H], want[H:2 * H],
                                       atol=2 * 0.01 * 3, rtol=0)
            got = np.concatenate([got[:H], got[2 * H:]])
            want = np.concatenate([want[:H], want[2 * H:]])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="accumulator"):
        optimizer_state_from_numpy({"global_step": 1, "nope@moment1":
                                    np.zeros(1)}, tm)


# ------------------------------------------------------- kernel routing

class _KernelRoute(Exception):
    pass


def test_fused_step_routes_by_device(monkeypatch):
    """Off the CPU (``meta`` tensors, the library a stub that raises) the
    table and the step go to the kernel library, never to the plain
    version; CPU tensors take the plain version and launch nothing."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_optimizer as fo

    def stub():
        raise _KernelRoute()
    monkeypatch.setattr(_build, "library", stub)
    m = dict(device="meta")
    with pytest.raises(_KernelRoute):
        fo.FusedTable([torch.empty(8, **m)], [None],
                      [[torch.empty(8, **m), torch.empty(8, **m)]], [0.0],
                      [1.0], [True])
    p = torch.ones(8)
    table = fo.FusedTable([p], [None], [[torch.zeros(8), torch.zeros(8)]],
                          [0.0], [1.0], [True])
    step = torch.zeros(1, dtype=torch.int32)
    n = fo.fused_adamw.launches
    fo.fused_adamw(table, [torch.full((8,), 0.5)], 0.1, step,
                   clip=("global", 1.0))
    assert fo.fused_adamw.launches == n and int(step) == 1
    assert torch.all(p < 1)


def test_fused_table_refuses_what_the_kernels_do_not_take():
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_optimizer as fo
    m = dict(device="meta")
    w = torch.empty(4, 4, **m)
    with pytest.raises(_build.KernelValueError, match="contiguous"):
        fo.FusedTable([w.t()], [None], [[None, None]], [0.0], [1.0], [True])
    with pytest.raises(_build.KernelTypeError, match="master"):
        fo.FusedTable([w.bfloat16()], [None], [[None, None]], [0.0], [1.0],
                      [True])
    with pytest.raises(_build.KernelTypeError, match="float32"):
        fo.FusedTable([w], [None], [[w.bfloat16(), None]], [0.0], [1.0],
                      [True])
    with pytest.raises(_build.KernelValueError, match="one entry"):
        fo.FusedTable([], [], [], [], [], [])
    with pytest.raises(_build.KernelValueError, match="rule"):
        fo.fused_adamw_reference(None, [], 0.1, None, rule="lion")
