"""The port's ``hapi`` (``Model``, callbacks, ``summary``, ``flops``) and
``metric`` against the JAX package's, on the CPU.

Counterparts of ``tests/test_hapi.py`` on an MLP of ``Linear`` layers and
on ``gpt3_tiny`` in place of LeNet (``vision`` is ROADMAP.md A.9).  The
same weights (the JAX ``[in, out]`` Linear weights transposed into
torch's ``[out, in]``), the same numpy data and one numpy seed before
each ``fit`` (so both samplers shuffle alike) go through both packages.

Tolerances: per-step losses of ``fit`` atol 1e-5 on the MLP and 1e-4 on
gpt3_tiny (float32 sums in other orders; the logits' tolerance of
``tests/test_torch_gpt.py``); parameters after the steps within 2 x lr x
steps (ROADMAP.md reference fact 6: Adam moves a weight whose gradient
is rounding noise by ~lr a step); under ``amp_configs`` the losses
within atol 2e-2, rtol 1e-2 (the two frameworks round to bfloat16 at
other places); metrics exactly (float64 accumulators over the same
numpy).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as tnn

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
import paddle_tpu_torch as ptt
from paddle_tpu_torch import hapi, metric as tmetric
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                             LRScheduler, ModelCheckpoint,
                                             ReduceLROnPlateau)
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn.functional import cross_entropy

AMP_TOL = dict(atol=2e-2, rtol=1e-2)


class Blobs:
    """Four classes of 8 features, learnable (module level, as a worker
    would need)."""

    def __init__(self, n=48, seed=0):
        rng = np.random.RandomState(seed)
        self.y = rng.randint(0, 4, n).astype(np.int64)
        self.x = rng.standard_normal((n, 8)).astype(np.float32) * 0.3
        self.x[np.arange(n), self.y * 2] += 1.0

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class Tokens:
    def __init__(self, n=12, S=16, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, 1024, (n, S)).astype(np.int64)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.ids[i]


def _mlp_pair(seed=0):
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tnet = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    with torch.no_grad():
        for (name, p) in jnet.named_parameters():
            v = np.asarray(p._value)
            tnet.get_parameter(name).copy_(torch.from_numpy(
                v.T.copy() if v.ndim == 2 else v.copy()))
    return jnet, tnet


def _t_ce(logits, labels):
    return cross_entropy(logits, labels)


def _prepared(jnet, tnet, lr=1e-2, **kw):
    jm = paddle.Model(jnet)
    jm.prepare(optimizer=paddle.optimizer.Adam(
        learning_rate=lr, parameters=jnet.parameters()),
        loss=jnn.CrossEntropyLoss(), jit_compile=False,
        metrics=jmetric.Accuracy(), **kw)
    tm = hapi.Model(tnet)
    tm.prepare(optimizer=toptim.Adam(learning_rate=lr,
                                     parameters=tnet.named_parameters()),
               loss=_t_ce, metrics=tmetric.Accuracy(), **kw)
    return jm, tm


class _JLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class _TLosses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _fit_both(jm, tm, data, **kw):
    out = []
    for m, cb in ((jm, _JLosses()), (tm, _TLosses())):
        np.random.seed(5)
        logs = m.fit(data, callbacks=[cb], verbose=0, **kw)
        out.append((cb.losses, logs))
    return out


def _assert_params(jnet, tnet, atol):
    for name, p in jnet.named_parameters():
        v = np.asarray(p._value.astype(np.float32))
        got = tnet.get_parameter(name).detach().float().numpy()
        np.testing.assert_allclose(got, v.T if v.ndim == 2 else v,
                                   atol=atol, err_msg=name)


def test_mlp_fit_matches_jax():
    """Three shuffled epochs of 12 steps: every step's loss, the epoch's
    accuracy and the final parameters equal the JAX ``Model.fit``'s."""
    jnet, tnet = _mlp_pair()
    jm, tm = _prepared(jnet, tnet)
    (jl, jlogs), (tl, tlogs) = _fit_both(jm, tm, Blobs(), batch_size=4,
                                         epochs=3, shuffle=True)
    assert len(tl) == len(jl) == 36
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert tlogs["acc"] == pytest.approx(jlogs["acc"])
    assert tl[-1] < tl[0]
    _assert_params(jnet, tnet, atol=2 * 1e-2 * 36)


def test_gpt_fit_matches_jax_and_feeds_the_timeline():
    """gpt3_tiny as the network with the LM loss: two epochs of 3 steps
    equal the JAX package's losses; each step is one record of the
    default ``StepTimeline`` (tokens = B x S) and one loss sync."""
    from paddle_tpu_torch.observability import metrics, telemetry
    paddle.seed(1)
    jnet = JaxGPT(jax_tiny())
    tnet = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=2)
    tnet.load_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jnet.state_dict().items()},
        tnet))
    lr = 1e-3
    jm = paddle.Model(jnet)
    jm.prepare(optimizer=paddle.optimizer.AdamW(
        learning_rate=lr, parameters=jnet.parameters()),
        loss=lambda lo, la: jF.cross_entropy(lo.reshape([-1, 1024]),
                                             la.reshape([-1])),
        jit_compile=False)
    tm = hapi.Model(tnet)
    tm.prepare(optimizer=toptim.AdamW(learning_rate=lr,
                                      parameters=tnet.named_parameters()),
               loss=lambda lo, la: cross_entropy(lo.reshape(-1, 1024),
                                                 la.reshape(-1)),
               jit_compile=True)
    tl_ = telemetry.default_timeline()
    tl_.reset()
    syncs = metrics.snapshot().get("train.loss_syncs", {})
    (jl, _), (tl, _) = _fit_both(jm, tm, Tokens(), batch_size=4, epochs=2)
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    recs = tl_.records
    assert len(recs) == 6 and all(r["tokens"] == 64 for r in recs)
    assert all(r["synced"] for r in recs)
    assert metrics.snapshot()["train.loss_syncs"] != syncs
    want = state_from_numpy({k: np.asarray(v._value)
                             for k, v in jnet.state_dict().items()}, tnet)
    for name, p in tnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=2 * lr * 6, err_msg=name)


def test_evaluate_predict_save_and_load(tmp_path):
    """``evaluate`` and ``predict`` give the JAX package's loss, accuracy
    and outputs; ``save`` then ``load`` into a fresh model gives the same
    outputs and restores the optimizer's moments and step."""
    jnet, tnet = _mlp_pair(3)
    jm, tm = _prepared(jnet, tnet)
    _fit_both(jm, tm, Blobs(24), batch_size=8, epochs=1)
    data = Blobs(16, seed=1)
    jr = jm.evaluate(data, batch_size=8, verbose=0)
    tr = tm.evaluate(data, batch_size=8, verbose=0)
    assert set(tr) == set(jr) == {"loss", "acc"}
    np.testing.assert_allclose(tr["loss"], jr["loss"], atol=1e-5)
    assert tr["acc"] == pytest.approx(jr["acc"])
    jp = jm.predict(data, batch_size=4, stack_outputs=True, verbose=0)
    tp = tm.predict(data, batch_size=4, stack_outputs=True, verbose=0)
    assert tp[0].shape == (16, 4)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), atol=1e-5)
    assert len(tm.predict(data, batch_size=4, verbose=0)[0]) == 4
    path = str(tmp_path / "ckpt" / "mlp")
    tm.save(path)
    assert os.path.exists(path + ".pdparams")
    assert os.path.exists(path + ".pdopt")
    _, fresh = _mlp_pair(9)
    tm2 = hapi.Model(fresh)
    tm2.prepare(optimizer=toptim.Adam(learning_rate=1e-2,
                                      parameters=fresh.named_parameters()),
                loss=_t_ce)
    tm2.load(path)
    x = data.x[:5]
    np.testing.assert_array_equal(tm2.predict_batch([x])[0],
                                  tm.predict_batch([x])[0])
    accs = tm2._optimizer._accumulators
    assert sum(len(v) for v in accs.values()) >= 2 * 4
    assert tm2._optimizer._global_step == tm._optimizer._global_step == 3
    # a JAX checkpoint loads with the port's load (the JAX format)
    jpath = str(tmp_path / "jax")
    jm.save(jpath, training=False)
    state = ptt.load(jpath + ".pdparams")
    assert set(state) == {"0.weight", "0.bias", "2.weight", "2.bias"}


def test_callbacks_fire_in_order_and_checkpoint(tmp_path):
    """Callbacks in the JAX order; ModelCheckpoint writes each epoch's and
    the final state; zero epochs is a no-op; the LRScheduler callback
    steps a scheduler once a step."""
    events = []

    class Recorder(Callback):
        def on_train_begin(self, logs=None): events.append("train_begin")
        def on_epoch_begin(self, epoch, logs=None): events.append("epoch_begin")
        def on_train_batch_end(self, step, logs=None): events.append("batch")
        def on_epoch_end(self, epoch, logs=None): events.append("epoch_end")
        def on_eval_end(self, logs=None): events.append("eval_end")
        def on_train_end(self, logs=None): events.append("train_end")

    _, tnet = _mlp_pair()
    sched = toptim.lr.StepDecay(learning_rate=0.1, step_size=1, gamma=0.5)
    tm = hapi.Model(tnet)
    tm.prepare(optimizer=toptim.Adam(learning_rate=sched,
                                     parameters=tnet.named_parameters()),
               loss=_t_ce)
    tm.fit(Blobs(16), eval_data=Blobs(8, seed=2), batch_size=8, epochs=2,
           verbose=0, callbacks=[Recorder()], save_dir=str(tmp_path))
    assert events == ["train_begin", "epoch_begin", "batch", "batch",
                      "epoch_end", "eval_end", "epoch_begin", "batch",
                      "batch", "epoch_end", "eval_end", "train_end"]
    for name in ("0", "1", "final"):
        assert os.path.exists(str(tmp_path / f"{name}.pdparams"))
    assert sched() == pytest.approx(0.1 * 0.5 ** 4)
    assert tm.fit(Blobs(8), batch_size=4, epochs=0, verbose=0) == {}
    # fit(checkpoint=) commits a version a step (the JAX package's
    # behaviour); resume without a checkpoint raises ValueError
    from paddle_tpu_torch.distributed.checkpoint import all_steps
    tm.fit(Blobs(8), batch_size=4, verbose=0, checkpoint=str(tmp_path / "ck"))
    assert all_steps(str(tmp_path / "ck")) == [1, 2]
    with pytest.raises(ValueError, match="requires checkpoint"):
        tm.fit(Blobs(8), resume=True)


def test_early_stopping_and_reduce_lr_on_plateau():
    _, tnet = _mlp_pair()
    tm = hapi.Model(tnet)
    tm.prepare(optimizer=toptim.Adam(learning_rate=0.0,
                                     parameters=tnet.named_parameters()),
               loss=_t_ce)
    es = EarlyStopping(monitor="loss", patience=0, verbose=0,
                       save_best_model=False)
    tm.fit(Blobs(16), eval_data=Blobs(8, seed=1), batch_size=8, epochs=6,
           verbose=0, callbacks=[es])
    assert tm.stop_training and es.wait_epoch > es.patience
    tm._optimizer.set_lr(0.1)
    cb = ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1, verbose=0)
    cb.set_model(tm)
    cb.on_eval_end({"loss": 1.0})
    cb.on_eval_end({"loss": 1.0})
    assert tm._optimizer.get_lr() == pytest.approx(0.05)
    assert isinstance(LRScheduler(), Callback)
    assert ModelCheckpoint(1, None).save_dir is None


def test_train_batch_accumulation_and_skip_mismatch(tmp_path):
    """``update=False`` accumulates without a step, the next update steps
    on the summed gradients and clears them; ``load(skip_mismatch=True)``
    into another architecture changes nothing."""
    _, tnet = _mlp_pair()
    tm = hapi.Model(tnet)
    tm.prepare(optimizer=toptim.SGD(learning_rate=0.1,
                                    parameters=tnet.named_parameters()),
               loss=_t_ce)
    data = Blobs(8)
    x, y = data.x, data.y
    w = tnet[0].weight
    before = w.detach().clone()
    tm.train_batch([x], [y], update=False)
    assert w.grad is not None and w.grad.abs().sum() > 0
    assert torch.equal(w.detach(), before)
    g1 = w.grad.clone()
    tm.train_batch([x], [y], update=True)
    assert torch.allclose(w.detach(), before - 0.1 * 2 * g1, atol=1e-6)
    assert w.grad is None or not w.grad.any()
    path = str(tmp_path / "m")
    tm.save(path)
    other = tnn.Linear(4, 4)
    keep = other.weight.detach().clone()
    hapi.Model(other).load(path, skip_mismatch=True)
    assert torch.equal(other.weight.detach(), keep)


@pytest.mark.parametrize("amp_configs", [
    "O1", {"level": "O2"}, {"level": "O1", "init_loss_scaling": 1024.0},
    {"level": "O1", "dtype": "float16"},
    {"level": "O1", "custom_black_list": ["divide"],
     "custom_white_list": ["embedding"]}])
def test_amp_configs_train_like_jax(amp_configs):
    """``amp_configs`` as ``_check_amp_configs`` reads them: a level, a
    dict of ``auto_cast`` keys (custom lists too) and ``GradScaler`` keys
    (a scaler for float16 or any scaler key), the losses within AMP_TOL of
    the JAX package's."""
    jnet, tnet = _mlp_pair(4)
    jm, tm = _prepared(jnet, tnet, amp_configs=amp_configs)
    scaled = isinstance(amp_configs, dict) and (
        "init_loss_scaling" in amp_configs or "dtype" in amp_configs)
    assert (tm._scaler is not None) == scaled
    (jl, _), (tl, _) = _fit_both(jm, tm, Blobs(24), batch_size=8, epochs=2)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, **AMP_TOL)


def test_invalid_amp_level_raises():
    tm = hapi.Model(tnn.Linear(2, 2))
    with pytest.raises(ValueError):
        tm.prepare(amp_configs="O7")


def test_summary_and_flops_equal_jax():
    """``summary`` counts the JAX package's parameters on the MLP and on
    gpt3_tiny; ``flops`` the JAX package's MACs on the MLP, with
    ``custom_ops`` and the detail table.  Both packages' ``flops`` feed
    float zeros, which a token-id model refuses: gpt3_tiny raises in
    both."""
    jnet, tnet = _mlp_pair()
    assert hapi.summary(tnet, verbose=0) == paddle.summary(jnet, verbose=0)
    jg = JaxGPT(jax_tiny())
    tg = GPTForCausalLM(gpt3_tiny(), device="cpu")
    assert hapi.summary(tg, verbose=0) == paddle.summary(jg, verbose=0)
    assert hapi.Model(tg).summary() == paddle.summary(jg, verbose=0)
    tnet.train()
    assert hapi.flops(tnet, [2, 8]) == paddle.flops(jnet, [2, 8]) == \
        2 * 16 * 8 + 2 * 16 + 2 * 4 * 16
    assert tnet.training
    assert hapi.flops(tnet, [2, 8], custom_ops={tnn.Linear: lambda m, x, y:
                                                7}) == 7 + 7 + 2 * 16
    with pytest.raises(ValueError, match="integer"):
        paddle.flops(jg, [1, 16])
    with pytest.raises(RuntimeError, match="Long, Int"):
        hapi.flops(tg, [1, 16])
    assert tg.training


# ---------------------------------------------------------------- metrics

def test_metrics_equal_jax():
    """Accuracy (top-1/top-3, ties, column and one-hot labels),
    Precision, Recall, Auc (bucketed ROC) and the functional ``accuracy``
    on the same numpy, over two updates, torch tensors and numpy."""
    rng = np.random.RandomState(0)
    preds = [np.round(rng.rand(20, 5), 1).astype(np.float32)
             for _ in range(2)]
    labels = [rng.randint(0, 5, (20, 1)).astype(np.int64) for _ in range(2)]
    ja, ta = jmetric.Accuracy(topk=(1, 3)), tmetric.Accuracy(topk=(1, 3))
    for p, lab in zip(preds, labels):
        jr = ja.update(ja.compute(paddle.to_tensor(p),
                                  paddle.to_tensor(lab)))
        tr = ta.update(ta.compute(torch.from_numpy(p), torch.from_numpy(lab)))
        assert tr == jr
    onehot = np.eye(5, dtype=np.float32)[labels[0][:, 0]]
    assert np.array_equal(
        ta.compute(torch.from_numpy(preds[0]), onehot).numpy(),
        np.asarray(ja.compute(paddle.to_tensor(preds[0]),
                              paddle.to_tensor(onehot))._value))
    assert ta.accumulate() == ja.accumulate() and ta.name() == ja.name()
    scores = [rng.rand(30).astype(np.float32) for _ in range(2)]
    bins = [rng.randint(0, 2, 30).astype(np.int64) for _ in range(2)]
    for jcls, tcls in ((jmetric.Precision, tmetric.Precision),
                       (jmetric.Recall, tmetric.Recall)):
        jm_, tm_ = jcls(), tcls()
        for s, b in zip(scores, bins):
            jm_.update(s, b)
            tm_.update(torch.from_numpy(s), b)
        assert tm_.accumulate() == jm_.accumulate()
        assert tm_.name() == jm_.name()
    for curve in ("ROC", "PR"):
        jauc = jmetric.Auc(curve=curve, num_thresholds=255)
        tauc = tmetric.Auc(curve=curve, num_thresholds=255)
        for s, b in zip(scores, bins):
            two = np.stack([1 - s, s], 1)
            jauc.update(two, b)
            tauc.update(torch.from_numpy(two), torch.from_numpy(b))
        assert tauc.accumulate() == jauc.accumulate() > 0
    for k in (1, 2):
        want = jmetric.accuracy(paddle.to_tensor(preds[1]),
                                paddle.to_tensor(labels[1]), k=k)
        got = tmetric.accuracy(torch.from_numpy(preds[1]),
                               torch.from_numpy(labels[1]), k=k)
        assert got.item() == float(np.asarray(want._value))
