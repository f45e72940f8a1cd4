"""The port's hybrid topology, tensor-parallel layers, RNG tracker and
tensor-parallel training (GPT, Llama, BERT), on the CPU, against the JAX
package.

The module shares two spawned worlds of CPU ranks over gloo (2 and 4
processes, started once, ``_torch_world.py``): every rank is this file
run as a script, which imports the port and torch, never jax.  The JAX
package runs on its 8-virtual-device CPU mesh (``tests/conftest.py``)
under the ``dp 2 x mp 2 x sharding 2`` topology of its own tests
(``tests/test_distributed.py``, ``tests/test_models.py:75-105``,
``tests/test_bert.py:98``), where its tensor-parallel models compute on
global arrays; the port's ranks get the same numpy weights through
``models/convert.py`` (each rank its shard) and the same batches, and
gather their shards back (``full_state_dict``).

Tolerances (ROADMAP.md reference facts 3 and 6): losses and logits rtol
1e-4; gradients atol 1e-5; parameters after AdamW steps (lr 1e-4, as
``tests/test_torch_train.py``) atol 1e-5, the
key third of a qkv bias (zero gradient in exact arithmetic, moved by ~lr
a step on rounding noise) within 2 lr steps.  Dropout is held against the
port's own one-process run on the same weights and seed: the masks are
the same bits, so losses agree to 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_world import ROOT, World, serve  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

W_SIZES = (2, 4)
# bench.py's learning rate: Adam moves a weight whose gradient is tiny by
# up to lr on rounding noise (reference fact 6), so lr 1e-3 would put such
# weights 2e-5 apart
LR = 1e-4
STEPS = 2


# ---------------------------------------------------------------- ranks
def _fleet(dp=1, mp=1, sharding=1, pp=1):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                            sharding_degree=sharding, sep_degree=1)
    return fleet.init(is_collective=True, strategy=s)


def _np(t):
    return t.detach().float().cpu().numpy()


def task_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def task_topology(dims):
    hcg = _fleet(**dims)
    groups = {a: (g.ranks, g.rank, g.nranks) for a, g in (
        ("dp", hcg.get_data_parallel_group()),
        ("mp", hcg.get_model_parallel_group()),
        ("pp", hcg.get_pipe_parallel_group()),
        ("sharding", hcg.get_sharding_parallel_group()),
        ("sep", hcg.get_sep_parallel_group()))}
    # a rank's place in each axis's group is its coordinate on that axis
    coord = (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
             hcg.get_sharding_parallel_rank(), hcg.get_sep_parallel_rank(),
             hcg.get_model_parallel_rank())
    return dict(coord=coord, groups=groups, mode=hcg.get_parallel_mode(),
                sizes=(hcg.get_data_parallel_world_size(),
                       hcg.get_pipe_parallel_world_size(),
                       hcg.get_sharding_parallel_world_size(),
                       hcg.get_sep_parallel_world_size(),
                       hcg.get_model_parallel_world_size()),
                first_last=(hcg.is_first_stage(), hcg.is_last_stage()))


def task_layers(w, x, ids):
    """Column -> row, a gathered column and a split-input row, and a
    vocab-parallel embedding on the JAX test's weights ``w`` (JAX
    layout); values and gathered gradients."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.mp_layers import gather_full
    from paddle_tpu_torch.models.convert import local_shard
    _fleet(mp=2)

    def load(layer, weight, bias=None):
        with torch.no_grad():
            layer.weight.copy_(local_shard(torch.from_numpy(weight),
                                           layer.weight))
            if bias is not None:
                layer.bias.copy_(local_shard(torch.from_numpy(bias),
                                             layer.bias))

    def grads(*layers):
        return [_np(gather_full(p, p.grad)) for m in layers
                for p in m.parameters()]
    col = fleet.ColumnParallelLinear(8, 16, gather_output=False)
    row = fleet.RowParallelLinear(16, 8, input_is_parallel=True)
    load(col, w["col_w"].T, w["col_b"])
    load(row, w["row_w"].T, w["row_b"])
    xt = torch.from_numpy(x)
    out = row(col(xt))
    out.sum().backward()
    res = {"pair": _np(out), "pair_grads": grads(col, row),
           "col_shape": tuple(col.weight.shape),
           "row_shape": tuple(row.weight.shape)}
    col2 = fleet.ColumnParallelLinear(8, 16, gather_output=True)
    row2 = fleet.RowParallelLinear(16, 8, input_is_parallel=False)
    load(col2, w["col_w"].T, w["col_b"])
    load(row2, w["row_w"].T, w["row_b"])
    out = row2(col2(xt))
    out.sum().backward()
    res["gathered"] = _np(out)
    res["gathered_grads"] = grads(col2, row2)
    emb = fleet.VocabParallelEmbedding(64, 16)
    load(emb, w["emb"])
    e = emb(torch.from_numpy(ids))
    (e * torch.arange(16.0)).sum().backward()
    res["emb"] = _np(e)
    res["emb_grad"] = grads(emb)[0]
    res["emb_shape"] = tuple(emb.weight.shape)
    return res


def task_rng(seed):
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.distributed.fleet import get_rng_state_tracker
    from paddle_tpu_torch.distributed.fleet.random import (
        model_parallel_random_seed)
    model_parallel_random_seed(seed)
    tracker = get_rng_state_tracker()
    with tracker.rng_state():
        a = trandom.next_key()
        b = trandom.next_key()
    g = trandom.next_key()
    state = tracker.get_states_tracker()
    with tracker.rng_state():
        c = trandom.next_key()
    tracker.set_states_tracker(state)
    with tracker.rng_state():
        c2 = trandom.next_key()
    return [[int(w) for w in k] for k in (a, b, g, c, c2)]


def _build(family, cfg_kw, device="cpu", seed=0):
    if family == "gpt":
        from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
        return GPTForCausalLM(gpt3_tiny(**cfg_kw), device=device, seed=seed)
    if family == "llama":
        from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                                   llama_tiny)
        return LlamaForCausalLM(llama_tiny(**cfg_kw), device=device,
                                seed=seed)
    from paddle_tpu_torch.models.bert import BertForMaskedLM, bert_tiny
    return BertForMaskedLM(bert_tiny(**cfg_kw), device=device, seed=seed)


def _train(model, opt, scaler, batches, steps):
    losses = []
    for ids, labels in batches[:steps]:
        loss = model.compute_loss(torch.from_numpy(ids),
                                  torch.from_numpy(labels))
        (scaler.scale(loss) if scaler is not None else loss).backward()
        if scaler is not None:
            scaler.step(opt)
        else:
            opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _optimizer(model, clip, mp_wrap=True, list_rules=False):
    """AdamW with a global clip; ``list_rules``: the clip is a subclass,
    which the fused step declines (the list rules and the scaler's host
    path run)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    class Clip(tnn.ClipGradByGlobalNorm):
        pass
    cls = Clip if list_rules else tnn.ClipGradByGlobalNorm
    opt = AdamW(learning_rate=LR, parameters=list(model.named_parameters()),
                weight_decay=0.01, grad_clip=cls(clip) if clip else None)
    return fleet.distributed_optimizer(opt) if mp_wrap else opt


def task_tp_model(family, cfg_kw, state, batches, dims, clip, scale,
                  steps=STEPS, list_rules=False):
    """A tensor-parallel model on this rank's shard of ``state`` (the JAX
    layout, global): the loss and the gathered gradients of the first
    batch, then ``steps`` AdamW steps with a global clip and a GradScaler
    (this rank's data-parallel slice of each batch); the losses
    (averaged over the data-parallel group) and the gathered
    parameters."""
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.mp_layers import gather_full
    from paddle_tpu_torch.models.convert import (_linear_weights,
                                                 full_state_dict,
                                                 state_from_numpy)
    hcg = _fleet(**dims)
    model = _build(family, dict(cfg_kw, tensor_parallel=True))
    model.load_state_dict(state_from_numpy(state, model), strict=True)
    dp, dr = hcg.get_data_parallel_world_size(), \
        hcg.get_data_parallel_rank()
    mine = [(i[dr::dp], l[dr::dp]) for i, l in batches]
    ids, labels = (torch.from_numpy(a) for a in batches[0])
    loss0 = model.compute_loss(ids, labels)
    loss0.backward()
    names = dict(model.named_parameters())
    linear = _linear_weights(model)
    grads = {n: _np(gather_full(p, p.grad)) for n, p in names.items()
             if p.grad is not None}
    grads = {n: g.T if n in linear else g for n, g in grads.items()}
    for p in model.parameters():
        p.grad = None
    wrapped = fleet.distributed_model(model)
    opt = _optimizer(model, clip, list_rules=list_rules)
    scaler = tamp.GradScaler(init_loss_scaling=scale) if scale else None
    losses = []
    for i, l in mine[:steps]:
        loss = wrapped.compute_loss(torch.from_numpy(i), torch.from_numpy(l))
        (scaler.scale(loss) if scaler is not None else loss).backward()
        if scaler is not None:
            scaler.step(opt)
        else:
            opt.step()
        opt.clear_grad()
        lt = loss.detach().clone()
        dist.all_reduce(lt, "avg", hcg.get_data_parallel_group())
        losses.append(float(lt))
    sizes = {n: tuple(p.shape) for n, p in names.items()}
    return dict(loss0=loss0.item(), grads=grads, losses=losses,
                params={k: v.numpy() for k, v in
                        full_state_dict(model, jax_layout=True).items()},
                sizes=sizes,
                kinds=_fused_kinds())


def _fused_kinds():
    from paddle_tpu_torch.observability import metrics
    snap = metrics.snapshot().get("optimizer.fused") or {"series": []}
    return {x["labels"]["kind"]: x["value"] for x in snap["series"]}


def task_tp_dropout(state, batches, mp):
    """GPT-tiny with dropout 0.1 at ``mp`` ranks: one AdamW step's loss
    and the gathered parameters after it."""
    from paddle_tpu_torch.models.convert import (full_state_dict,
                                                 state_from_numpy)
    _fleet(mp=mp)
    model = _build("gpt", dict(dropout=0.1, tensor_parallel=True), seed=7)
    model.load_state_dict(state_from_numpy(state, model), strict=True)
    model.train()
    opt = _optimizer(model, 1.0)
    losses = _train(model, opt, None, batches, 2)
    return losses, {k: v.numpy() for k, v in
                    full_state_dict(model, jax_layout=True).items()}


def task_refusals():
    """distributed_model at pp 2 names the next slice; Llama's kv heads
    that the degree does not divide raise before any collective."""
    from paddle_tpu_torch.distributed import fleet
    out = {}
    _fleet(pp=2)
    try:
        fleet.distributed_model(torch.nn.Linear(2, 2))
    except NotImplementedError as e:
        out["pp"] = str(e)
    _fleet(mp=2)
    try:
        _build("llama", dict(num_kv_heads=1, tensor_parallel=True))
    except ValueError as e:
        out["gqa"] = str(e)
    return out


TASKS = {k: v for k, v in globals().items() if k.startswith("task_")}


# ----------------------------------------------------------- controller
@pytest.fixture(scope="module")
def worlds():
    ws = {W: World(W, __file__) for W in W_SIZES}
    yield ws
    for w in ws.values():
        w.close()


@pytest.fixture
def jax_hybrid():
    """The JAX package's dp 2 x mp 2 x sharding 2 topology on its CPU
    mesh, removed after the test."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed import mesh as jmesh
    old = jmesh.get_mesh()
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1,
                        "sharding_degree": 2, "sep_degree": 1}
    hcg = jfleet.init(is_collective=True, strategy=s)
    yield hcg
    jmesh.set_mesh(old)


def test_ranks_import_neither_jax_nor_the_jax_package(worlds):
    for w in worlds.values():
        assert w.run("task_modules") == [[]] * w.W


def test_communicate_topology_matches_the_jax_class():
    from paddle_tpu.distributed.fleet import CommunicateTopology as JT
    from paddle_tpu_torch.distributed.fleet import CommunicateTopology as TT
    for names, dims in ((["data", "model"], [2, 4]),
                        (["data", "pipe", "sharding", "sep", "model"],
                         [2, 1, 2, 1, 2]),
                        (["data", "pipe", "sharding", "sep", "model"],
                         [1, 2, 2, 1, 2])):
        j, t = JT(names, dims), TT(names, dims)
        assert t.world_size() == j.world_size()
        for r in range(j.world_size()):
            assert t.get_coord(r) == tuple(int(c) for c in j.get_coord(r))
            assert t.get_rank(**dict(zip(names, t.get_coord(r)))) == r
        for n in names:
            assert t.get_comm_list(n) == j.get_comm_list(n)
            assert t.get_axis_list(n, 1 % t.get_dim(n)) == \
                j.get_axis_list(n, 1 % j.get_dim(n))
    assert TT(["data", "model"], [2, 4]).get_rank(data=1, model=2) == 6


@pytest.mark.parametrize("dims", [dict(dp=2, mp=2), dict(mp=2, sharding=2),
                                  dict(pp=2, dp=2)])
def test_hybrid_groups_place_ranks_as_the_jax_mesh(worlds, dims):
    """Rank r's (dp, pp, sharding, sep, mp) are the JAX mesh's device r's
    (pp outermost, mp innermost), and each axis's group is the ranks
    that differ in that coordinate alone."""
    import jax
    from paddle_tpu.distributed.mesh import build_mesh
    sizes = {"pp": dims.get("pp", 1), "dp": dims.get("dp", 1),
             "sharding": dims.get("sharding", 1), "sep": 1,
             "mp": dims.get("mp", 1)}
    mesh = build_mesh(sizes, jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    ids = ids - ids.min()
    order = ("dp", "pp", "sharding", "sep", "mp")
    axes = list(mesh.axis_names)
    want = {}
    for pos in np.ndindex(ids.shape):
        c = dict(zip(axes, pos))
        want[int(ids[pos])] = tuple(c[a] for a in order)
    got = worlds[4].run("task_topology", dims)
    for r, res in enumerate(got):
        assert res["coord"] == want[r]
        for i, a in enumerate(order):
            ranks, grank, n = res["groups"][a]
            assert ranks == sorted(q for q in range(4) if all(
                want[q][j] == want[r][j] for j in range(5) if j != i))
            assert (grank, n) == (ranks.index(r), sizes[a])
        assert res["sizes"] == tuple(sizes[a] for a in order)
        stage = res["coord"][1]
        assert res["first_last"] == (stage == 0, stage == sizes["pp"] - 1)
        assert res["mode"] == (1 if sizes["mp"] > 1 else
                               2 if sizes["pp"] > 1 else 3)


def test_parallel_layers_match_the_jax_layers(worlds, jax_hybrid):
    import paddle_tpu as paddle
    import jax.numpy as jnp
    from paddle_tpu.distributed import fleet as jfleet
    rng = np.random.RandomState(0)
    w = {"col_w": rng.randn(8, 16).astype(np.float32) * 0.3,
         "col_b": rng.randn(16).astype(np.float32) * 0.1,
         "row_w": rng.randn(16, 8).astype(np.float32) * 0.3,
         "row_b": rng.randn(8).astype(np.float32) * 0.1,
         "emb": rng.randn(64, 16).astype(np.float32)}
    x = rng.randn(4, 8).astype(np.float32)
    ids = rng.randint(0, 64, (2, 5))

    def jset(p, v):
        p._value = jnp.asarray(v)

    col = jfleet.ColumnParallelLinear(8, 16, gather_output=False)
    row = jfleet.RowParallelLinear(16, 8, input_is_parallel=True)
    for p, k in ((col.weight, "col_w"), (col.bias, "col_b"),
                 (row.weight, "row_w"), (row.bias, "row_b")):
        jset(p, w[k])
    out = row(col(paddle.to_tensor(x)))
    out.sum().backward()
    want = np.asarray(out._value)
    want_g = [np.asarray(p.grad._value) for p in (col.weight, col.bias,
                                                  row.weight, row.bias)]
    emb = jfleet.VocabParallelEmbedding(64, 16)
    jset(emb.weight, w["emb"])
    e = emb(paddle.to_tensor(ids.astype(np.int32)))
    (e * paddle.to_tensor(np.arange(16, dtype=np.float32))).sum().backward()
    for res in worlds[2].run("task_layers", w, x, ids):
        assert res["col_shape"] == (8, 8) and res["row_shape"] == (8, 8)
        assert res["emb_shape"] == (32, 16)
        for key in ("pair", "gathered"):
            np.testing.assert_allclose(res[key], want, rtol=1e-5, atol=1e-5)
        for gk in ("pair_grads", "gathered_grads"):
            # the port's [out, in] weights against the JAX [in, out]
            got = [g.T if g.ndim == 2 else g for g in res[gk]]
            for a, b in zip(got, want_g):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["emb"], np.asarray(e._value),
                                   rtol=1e-6)
        np.testing.assert_allclose(res["emb_grad"],
                                   np.asarray(emb.weight.grad._value),
                                   rtol=1e-6)


def test_rng_tracker_matches_the_jax_key_sources(worlds):
    import jax
    from paddle_tpu.framework import random as jrandom
    res = worlds[2].run("task_rng", 123)
    for r, (a, b, g, c, c2) in enumerate(res):
        local = jrandom.StatefulKeySource(123 + 1024 + r)
        ja = np.asarray(jax.random.key_data(local.next_key())).tolist()
        jb = np.asarray(jax.random.key_data(local.next_key())).tolist()
        assert (a, b) == (ja, jb) and a != b
        glob = jrandom.StatefulKeySource(123)
        assert g == np.asarray(jax.random.key_data(glob.next_key())).tolist()
        assert c == c2            # set_states_tracker restores
    assert res[0][0] != res[1][0]   # rank-local states differ


# ------------------------------------------------------ the models
def _batches(vocab, n, B=4, S=16, seed=3, mlm=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
        labels = rng.randint(0, vocab, (B, S)).astype(np.int64)
        if mlm:
            labels[rng.rand(B, S) < 0.5] = -100
        out.append((ids, labels))
    return out


def _jax_model(family, cfg_kw, seed):
    import paddle_tpu as paddle
    paddle.seed(seed)
    if family == "gpt":
        from paddle_tpu.models.gpt import GPTForCausalLM, gpt3_tiny
        return GPTForCausalLM(gpt3_tiny(tensor_parallel=True, **cfg_kw))
    if family == "llama":
        from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny
        return LlamaForCausalLM(llama_tiny(tensor_parallel=True, **cfg_kw))
    from paddle_tpu.models.bert import BertForMaskedLM, bert_tiny
    return BertForMaskedLM(bert_tiny(tensor_parallel=True, **cfg_kw))


def _jax_run(family, cfg_kw, batches, clip, scale, steps=STEPS, seed=5):
    """The JAX package's tensor-parallel model on its mesh: the state,
    the first batch's loss and gradients, then ``steps`` AdamW steps
    (global clip, GradScaler) on the whole batches."""
    import paddle_tpu as paddle
    from paddle_tpu import amp as jamp
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as joptim
    jm = _jax_model(family, cfg_kw, seed)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}

    def t(a):
        return paddle.to_tensor(a.astype(np.int32))
    loss0 = jm.compute_loss(t(batches[0][0]), t(batches[0][1]))
    loss0.backward()
    names = dict(jm.named_parameters())
    grads = {n: np.asarray(p.grad._value) for n, p in names.items()
             if p.grad is not None}
    for p in jm.parameters():
        p.clear_gradient()
    opt = joptim.AdamW(learning_rate=LR, parameters=jm.parameters(),
                       weight_decay=0.01,
                       grad_clip=jnn.ClipGradByGlobalNorm(clip)
                       if clip else None)
    scaler = jamp.GradScaler(init_loss_scaling=scale) if scale else None
    losses = []
    for ids, labels in batches[:steps]:
        loss = jm.compute_loss(t(ids), t(labels))
        (scaler.scale(loss) if scaler is not None else loss).backward()
        if scaler is not None:
            scaler.step(opt)
        else:
            opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))
    after = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return state, float(loss0.item()), grads, losses, after


def _assert_params(got, want, bias_key_slices=True, bound=None):
    bound = bound if bound is not None else 2 * LR * STEPS
    for k, v in want.items():
        g = got[k]
        assert g.shape == v.shape, (k, g.shape, v.shape)
        if bias_key_slices and k.endswith("qkv.bias"):
            H = v.shape[0] // 3
            np.testing.assert_allclose(g[H:2 * H], v[H:2 * H], atol=bound,
                                       err_msg=k)
            g, v = np.delete(g, np.s_[H:2 * H]), np.delete(v, np.s_[H:2 * H])
        np.testing.assert_allclose(g, v, atol=1e-5, rtol=0, err_msg=k)


MODELS = {"gpt": ({}, False), "llama": ({"num_kv_heads": 2}, False),
          "bert": ({"dropout": 0.0}, True)}


@pytest.mark.parametrize("family,list_rules",
                         [(f, False) for f in sorted(MODELS)]
                         + [("gpt", True)])
def test_tensor_parallel_models_match_the_jax_package(worlds, jax_hybrid,
                                                      family, list_rules):
    """mp 2: the loss, the gathered gradients, and the gathered
    parameters after 2 AdamW steps with ClipGradByGlobalNorm and a
    GradScaler, against the JAX model on its mesh; each rank holds half
    of every split weight and the fused step ran (no fallback).
    ``list_rules``: a subclass of the clip, which the fused step
    declines: the list rules clip by the cross-rank norm
    (``_global_norm_reduce_fn``) after the scaler's host path reduced
    ``found_inf``."""
    cfg_kw, mlm = MODELS[family]
    vocab = 1024
    batches = _batches(vocab, STEPS, mlm=mlm)
    clip, scale = 0.5, 1024.0
    state, loss0, grads, losses, after = _jax_run(family, cfg_kw, batches,
                                                  clip, scale)
    res = worlds[2].run("task_tp_model", family, cfg_kw, state, batches,
                        dict(mp=2), clip, scale, STEPS, list_rules)
    for r in res:
        np.testing.assert_allclose(r["loss0"], loss0, rtol=1e-4)
        assert r["grads"].keys() == grads.keys()
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"][k], g, atol=1e-5,
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        _assert_params(r["params"], after)
        if list_rules:      # declined by the scaler's step and the plain
            assert r["kinds"].get("fallback", 0) == 2 * STEPS
        else:
            assert r["kinds"].get("fallback", 0) == 0 and \
                r["kinds"].get("miss", 0) >= 1
    # each rank holds half of each split weight
    split = {"gpt": "gpt.blocks.0.attn.qkv.weight",
             "llama": "model.layers.0.mlp.gate_proj.weight",
             "bert": "bert.layers.0.intermediate.weight"}[family]
    assert res[0]["sizes"][split][0] * 2 == state[split].shape[1]
    assert res[0]["params"].keys() == after.keys()


def test_dp_mp_world_matches_the_jax_package(worlds, jax_hybrid):
    """dp 2 x mp 2 on 4 ranks: DataParallel over each data-parallel
    group (half the batch a rank), tensor parallelism inside; the losses
    and parameters after 2 steps equal the JAX model's on the whole
    batches."""
    batches = _batches(1024, STEPS, seed=11)
    state, _, _, losses, after = _jax_run("gpt", {}, batches, 1.0, None)
    res = worlds[4].run("task_tp_model", "gpt", {}, state, batches,
                        dict(dp=2, mp=2), 1.0, None)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        _assert_params(r["params"], after)


def test_tensor_parallel_dropout_draws_the_one_process_masks(worlds):
    """With dropout 0.1 (attention probabilities, residuals, embeddings)
    the mp-2 GPT's losses and parameters after a step equal the port's
    one-process model's on the same weights and seed: rank r's flash
    masks are the whole model's masks of its heads."""
    from paddle_tpu_torch.models.convert import full_state_dict
    single = _build("gpt", dict(dropout=0.1), seed=7)
    state = {k: v.numpy() for k, v in
             full_state_dict(single, jax_layout=True).items()}
    batches = _batches(1024, 2, seed=13)
    single.train()
    want = _train(single, _optimizer(single, 1.0, mp_wrap=False), None,
                  batches, 2)
    after = {k: v.numpy() for k, v in
             full_state_dict(single, jax_layout=True).items()}
    for losses, params in worlds[2].run("task_tp_dropout", state, batches,
                                        2):
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        _assert_params(params, after, bound=2 * LR * 2)


def test_refusals_name_the_slices_to_come(worlds):
    res = worlds[2].run("task_refusals")
    for r in res:
        assert "A.8.3" in r["pp"]
        assert "num_kv_heads 1" in r["gqa"]


def test_serving_refuses_a_training_layout_model():
    """``inference/tp.py``'s refusal of a ``tensor_parallel=True`` model,
    in its words."""
    from paddle_tpu_torch.inference import tp as ttp
    model = _build("gpt", dict(tensor_parallel=True))
    with pytest.raises(ValueError, match="tensor_parallel=True"):
        ttp.build_plan(model, 2)


if __name__ == "__main__":
    sys.exit(serve(TASKS))
