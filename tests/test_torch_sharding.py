"""The port's ZeRO (``group_sharded_parallel`` at ``os``, ``os_g`` and
``p_g_os``, stage-2 offload, ``GroupShardedOptimizerStage2``) on the CPU,
against the JAX package.

The module shares two spawned worlds of CPU ranks over gloo (2 and 4
processes, ``_torch_world.py``); the ranks import the port and torch,
never jax.  The sharding group is a data-parallel group: rank r takes
rows ``r * B / W ..`` of each global batch, and the gradients are
averaged, so after the steps the parameters equal the JAX package's
``group_sharded_parallel`` model trained on the whole batches on its
8-virtual-device mesh (``dp 2 x mp 2 x sharding 2``, where its arrays are
global).  Each rank keeps half of each divisible tensor's moments (and,
from stage 2, gradients; at stage 3, parameters), along the dimension the
JAX ``_shard_spec_for`` picks.

Tolerances as ``tests/test_torch_fleet.py``: losses rtol 1e-4,
parameters after AdamW steps (lr 1e-4) atol 1e-5 with the key third of a
qkv bias within 2 lr steps.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_world import ROOT, World, serve  # noqa: E402
from test_torch_fleet import (LR, _assert_params, _batches,  # noqa: E402
                              _fleet, jax_hybrid)

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STEPS = 3
W_SIZES = (2, 4)
# (level, offload, the scaler's unscale_ before its step)
LEVELS = [("os", False, False), ("os_g", False, False),
          ("p_g_os", False, False), ("os_g", True, False),
          ("p_g_os", False, True)]


# ---------------------------------------------------------------- ranks
def task_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def task_zero(level, offload, state, batches, dims, clip, scale,
              tensor_parallel=False, unscale=False):
    """``group_sharded_parallel(level)`` on gpt3_tiny over the sharding
    group (this rank's rows of each batch): the losses (averaged), the
    gathered parameters, and what this rank holds."""
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.distributed.fleet.sharding import state_bytes
    from paddle_tpu_torch.models.convert import (full_state_dict,
                                                 state_from_numpy)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _fleet(**dims)
    g = hcg.get_sharding_parallel_group()
    model = GPTForCausalLM(gpt3_tiny(tensor_parallel=tensor_parallel),
                           device="cpu")
    model.load_state_dict(state_from_numpy(state, model), strict=True)
    full_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    opt = AdamW(learning_rate=LR, parameters=list(model.named_parameters()),
                weight_decay=0.01,
                grad_clip=tnn.ClipGradByGlobalNorm(clip) if clip else None)
    model, opt, _ = group_sharded_parallel(model, opt, level,
                                           offload=offload)
    scaler = tamp.GradScaler(init_loss_scaling=scale) if scale else None
    metrics.reset()
    n, r = g.nranks, g.rank
    losses, grad_bytes = [], 0
    for ids, labels in batches:
        rows = slice(r * len(ids) // n, (r + 1) * len(ids) // n)
        loss = model.compute_loss(torch.from_numpy(ids[rows]),
                                  torch.from_numpy(labels[rows]))
        (scaler.scale(loss) if scaler is not None else loss).backward()
        if scaler is not None:
            if unscale:               # the recipe that clips in between
                scaler.unscale_(opt)
            scaler.step(opt)
        else:
            opt.step()
        held = {id(t): t.grad for t in list(model.parameters())
                + opt._parameter_list if t.grad is not None}
        grad_bytes = sum(t.numel() * t.element_size()
                         for t in held.values())
        opt.clear_grad()
        lt = loss.detach().clone()
        dist.all_reduce(lt, "avg", g)
        losses.append(float(lt))
    snap = metrics.snapshot().get("optimizer.fused") or {"series": []}
    held = {}
    for acc, store in opt._inner._accumulators.items():
        for name, t in store.items():
            if isinstance(t, torch.Tensor) and t.dim():
                held[f"{name}@{acc}"] = (tuple(t.shape), t.device.type)
    return dict(
        losses=losses,
        params={k: v.numpy() for k, v in
                full_state_dict(model, jax_layout=True).items()},
        state_bytes=state_bytes(opt), grad_bytes=grad_bytes,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        full_bytes=full_bytes, held=held,
        kinds={x["labels"]["kind"]: x["value"] for x in snap["series"]})


TASKS = {k: v for k, v in globals().items() if k.startswith("task_")}


# ----------------------------------------------------------- controller
@pytest.fixture(scope="module")
def worlds():
    ws = {W: World(W, __file__) for W in W_SIZES}
    yield ws
    for w in ws.values():
        w.close()


def _jax_zero(level, batches, clip, scale, tensor_parallel=False, seed=4):
    """The JAX package's ``group_sharded_parallel(level)`` on gpt3_tiny
    over its mesh, on the whole batches."""
    import paddle_tpu as paddle
    from paddle_tpu import amp as jamp
    from paddle_tpu import distributed as jdist
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as joptim
    from paddle_tpu.models.gpt import GPTForCausalLM, gpt3_tiny
    paddle.seed(seed)
    jm = GPTForCausalLM(gpt3_tiny(tensor_parallel=tensor_parallel))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    opt = joptim.AdamW(learning_rate=LR, parameters=jm.parameters(),
                       weight_decay=0.01,
                       grad_clip=jnn.ClipGradByGlobalNorm(clip)
                       if clip else None)
    jm, opt, _ = jdist.sharding.group_sharded_parallel(jm, opt, level)
    scaler = jamp.GradScaler(init_loss_scaling=scale) if scale else None
    losses = []
    for ids, labels in batches:
        loss = jm.compute_loss(paddle.to_tensor(ids.astype(np.int32)),
                               paddle.to_tensor(labels.astype(np.int32)))
        (scaler.scale(loss) if scaler is not None else loss).backward()
        if scaler is not None:
            scaler.step(opt)
        else:
            opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))
    return state, losses, {k: np.asarray(v._value)
                           for k, v in jm.state_dict().items()}


def test_ranks_import_neither_jax_nor_the_jax_package(worlds):
    for w in worlds.values():
        assert w.run("task_modules") == [[]] * w.W


@pytest.mark.parametrize("level,offload,unscale", LEVELS)
def test_group_sharded_parallel_matches_the_jax_package(worlds, jax_hybrid,
                                                        level, offload,
                                                        unscale):
    """2 ranks, 3 AdamW steps with ClipGradByGlobalNorm and a GradScaler:
    losses and parameters as the JAX model's on the whole batches; a rank
    holds about half the moments (and, from stage 2, the gradients; at
    stage 3 the parameters); the fused step's table is built once and
    then reused.  With ``unscale_`` first, the slices' gradients are
    reduced before the scaler reads them."""
    batches = _batches(1024, STEPS, B=4, seed=21)
    clip, scale = 0.5, 1024.0
    state, losses, after = _jax_zero(level, batches, clip, scale)
    res = worlds[2].run("task_zero", level, offload, state, batches,
                        dict(sharding=2), clip, scale, False, unscale)
    # the one-process sizes: the moments of every parameter, float32
    full = res[0]["full_bytes"]
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        _assert_params(r["params"], after, bound=2 * LR * STEPS)
        assert r["kinds"].get("fallback", 0) == 0
        assert r["kinds"].get("miss", 0) == 1
        # two moments of half of (nearly) every tensor: wpe's 256 rows,
        # the qkv and fc weights, the norms and biases all divide by 2
        assert r["state_bytes"] == full
        assert r["param_bytes"] == (full // 2 if level == "p_g_os"
                                    else full)
        # stage 1 keeps the whole gradients besides the owned slices'
        if level == "os":
            assert r["grad_bytes"] >= full
        else:
            assert r["grad_bytes"] == full // 2
        assert r["held"]["gpt.wte.weight@moment1"][0] == (512, 128)
        # the JAX layout [in, out] splits a linear weight's input rows:
        # the port's [out, in] keeps its columns
        assert r["held"]["gpt.blocks.0.attn.qkv.weight@moment1"][0] == \
            (384, 64)
        # offload: the state is host memory between steps (on the CPU
        # ranks it is there anyway)
        assert {d for _, d in r["held"].values()} == {"cpu"}


def test_zero_composes_with_tensor_parallelism(worlds, jax_hybrid):
    """mp 2 x sharding 2 on 4 ranks, stage 2: a tensor-parallel shard
    keeps its mp dimension and ZeRO takes another (the JAX
    ``test_zero_sharding_preserves_tp_layout``); the norms sum over both
    groups; parameters as the JAX tensor-parallel model's."""
    batches = _batches(1024, STEPS, B=4, seed=23)
    state, losses, after = _jax_zero("os_g", batches, 1.0, None,
                                     tensor_parallel=True)
    res = worlds[4].run("task_zero", "os_g", False, state, batches,
                        dict(mp=2, sharding=2), 1.0, None, True)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        _assert_params(r["params"], after, bound=2 * LR * STEPS)
        # qkv: [3H / mp, H] on a rank, ZeRO on the H columns
        assert r["held"]["gpt.blocks.0.attn.qkv.weight@moment1"][0] == \
            (192, 64)
        # the vocab-parallel table [V / mp, H]: ZeRO on H
        assert r["held"]["gpt.wte.weight@moment1"][0] == (512, 64)


def test_zero_dims_follow_the_jax_rule(jax_hybrid):
    """``zero_dim`` on the port's layout picks the JAX ``_shard_spec_for``
    dimension of the JAX layout: the first free divisible one, the TP
    one kept, an indivisible tensor whole (one warning per shape)."""
    import warnings
    from paddle_tpu.distributed.fleet import sharding as jsh
    from paddle_tpu_torch.distributed.fleet import sharding as tsh
    cases = [((3, 8), False, None), ((4, 6), False, None),
             ((8, 4), True, None), ((3, 5), False, None),
             ((30522, 8), False, 0), ((8, 30), True, 0)]
    for shape, transposed, mp_axis in cases:
        p = torch.nn.Parameter(torch.zeros(shape))
        jshape = shape[::-1] if transposed else shape
        existing = None
        if mp_axis is not None:
            p.mp_split, p.split_axis = True, mp_axis
            from jax.sharding import NamedSharding, PartitionSpec as P
            from paddle_tpu.distributed import mesh as jmesh
            jaxis = (1 - mp_axis) if transposed else mp_axis
            spec = [None, None]
            spec[jaxis] = "mp"
            existing = NamedSharding(jmesh.get_mesh(), P(*spec))
        if transposed:
            p._jax_transposed = True
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jsh._shard_spec_for(jshape, existing)
            got = tsh.zero_dim(p, 2)
        if want is None:
            assert got is None, shape
        else:
            jdim = list(want.spec).index("sharding")
            assert got == ((len(shape) - 1 - jdim) if transposed
                           else jdim), (shape, want.spec)
    tsh._warned_shapes.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tsh.zero_dim(torch.nn.Parameter(torch.zeros(3, 5)), 2)
        tsh.zero_dim(torch.nn.Parameter(torch.zeros(3, 5)), 2)
    assert len([r for r in rec if "sharding" in str(r.message)]) == 1


def test_stage2_validates_params():
    from paddle_tpu_torch.distributed.fleet import (
        GroupShardedOptimizerStage2)
    from paddle_tpu_torch.optimizer import Adam
    lin = torch.nn.Linear(4, 4)
    opt = Adam(learning_rate=1e-3, parameters=list(lin.parameters()))
    GroupShardedOptimizerStage2(list(lin.parameters()), opt)      # ok
    other = torch.nn.Linear(2, 2)
    opt2 = Adam(learning_rate=1e-3, parameters=list(lin.parameters()))
    with pytest.raises(ValueError):
        GroupShardedOptimizerStage2(list(other.parameters()), opt2)


if __name__ == "__main__":
    sys.exit(serve(TASKS))
