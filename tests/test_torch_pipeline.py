"""The port's pipeline parallelism (``PipelineLayer``, ``PipelineParallel``,
``pipeline_forward``, ``interleaved_pipeline_forward``) and sequence-parallel
utilities on the CPU, against the JAX package.

The ranks are spawned worlds of 2 and 4 CPU processes over gloo
(``_torch_world.py``); they import the port and torch, never jax.  The JAX
package runs on its 8-virtual-device CPU mesh (``tests/conftest.py``): its
SPMD pipelines under ``shard_map`` over a ``pp`` axis, its sequence-
parallel layers under the ``dp 2 x mp 2 x sharding 2`` topology, its host
pipeline in one process.  Inputs and weights are numpy arrays from a
seed.  Tolerances: float32, rtol 2e-5 / atol 2e-6 for the pipelines'
outputs and rtol 3e-5 / atol 3e-6 for their gradients (the JAX tests'),
1e-5 elsewhere.
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
TIMEOUT = 120                # seconds a multi-rank task may take
WIDTH, MB = 8, 4


# ---------------------------------------------------------------- ranks
def task_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def _fleet(pp=1, dp=1, mp=1, accumulate=1):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                            sharding_degree=1, sep_degree=1)
    s.pipeline_configs["accumulate_steps"] = accumulate
    return fleet.init(is_collective=True, strategy=s), s


def _stage_fn(params, h):
    return torch.tanh(h @ params["w"] + params["b"])


def task_pipeline(stages, inputs, target, vpp, remat):
    """This rank's stage (vpp 0: ``pipeline_forward``; else its ``vpp``
    chunks, global stage ``v * P + r``, through
    ``interleaved_pipeline_forward``): the outputs, and the gradients of
    the mean squared error against ``target`` at this rank's parameters
    and at the inputs."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import spmd_pipeline as sp
    hcg, _ = _fleet(pp=torch.distributed.get_world_size())
    P, r = hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()
    M = inputs.shape[0]
    x = torch.from_numpy(inputs).requires_grad_()
    if vpp:
        mine = [{k: torch.from_numpy(v) for k, v in stages[c * P + r]
                 .items()} for c in range(vpp)]
        params = {k: t.requires_grad_() for k, t in
                  sp.stack_stage_params(mine).items()}
        out = sp.interleaved_pipeline_forward(_stage_fn, params, x, M, vpp,
                                              remat=remat)
    else:
        params = {k: torch.from_numpy(v).requires_grad_()
                  for k, v in stages[r].items()}
        out = fleet.pipeline_forward(_stage_fn, params, x, M, remat=remat)
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    return dict(out=out.detach().numpy(), loss=float(loss),
                grads={k: p.grad.numpy() for k, p in params.items()},
                x_grad=x.grad.numpy() if x.grad is not None
                else np.zeros_like(inputs))


def task_ring(dev="cpu"):
    """``ring_permute`` of a rank-tagged tensor on ``dev`` and its
    backward; the p2p calls staged through the host."""
    from paddle_tpu_torch.distributed.fleet import spmd_pipeline as sp
    from paddle_tpu_torch.observability import metrics
    hcg, _ = _fleet(pp=torch.distributed.get_world_size())
    r = hcg.get_stage_id()
    metrics.reset()
    x = torch.full((3, 1024), float(r), device=dev, requires_grad=True)
    y = sp.ring_permute(x)
    assert y.device == x.device
    (y * (10.0 + r)).sum().backward()
    staged = metrics.snapshot().get("collective.host_staged") or \
        {"series": []}
    return (y[:, 0].tolist(), x.grad[:, 0].tolist(),
            sorted(s["labels"]["op"] for s in staged["series"]))


def _pipe_layer(weights, stages, seg="uniform"):
    import torch.nn as nn
    from paddle_tpu_torch.distributed.fleet import LayerDesc, PipelineLayer
    pipe = PipelineLayer(
        layers=[LayerDesc(nn.Linear, 4, 8), LayerDesc(nn.Tanh),
                LayerDesc(nn.Linear, 8, 4), LayerDesc(nn.Linear, 4, 1)],
        num_stages=stages, loss_fn=nn.MSELoss(), seg_method=seg)
    linears = [m for m in pipe.run_function if isinstance(m, nn.Linear)]
    with torch.no_grad():
        for m, (w, b) in zip(linears, weights):
            m.weight.copy_(torch.from_numpy(w.T))
            m.bias.copy_(torch.from_numpy(b))
    return pipe, linears


def task_pipeline_parallel(weights, X, Y, steps, scale):
    """``fleet.distributed_model`` of a ``PipelineLayer`` at pp 2
    (accumulate 2): ``steps`` of ``train_batch`` (SGD, a GradScaler when
    ``scale``), then ``eval_batch``; the losses and weights."""
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    _fleet(pp=2, accumulate=2)
    pipe, linears = _pipe_layer(weights, 2)
    model = fleet.distributed_model(pipe)
    opt = SGD(learning_rate=0.05, parameters=list(model.parameters()))
    scaler = tamp.GradScaler(init_loss_scaling=scale) if scale else None
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    losses = [float(model.train_batch((x, y), opt, scaler=scaler))
              for _ in range(steps)]
    return dict(kind=type(model).__name__, losses=losses,
                eval=float(model.eval_batch((x, y))),
                weights=[(m.weight.detach().numpy().T,
                          m.bias.detach().numpy()) for m in linears])


def task_pp_refusals():
    """In 2 ranks: pp 2 takes only a ``PipelineLayer``, and the
    interleaved class raises; in 4: pp 2 beside dp 2 or mp 2 raises (the
    host path would sum no gradient across them)."""
    from paddle_tpu_torch.distributed import fleet
    out = {}
    if torch.distributed.get_world_size() == 4:
        for kw in (dict(dp=2), dict(mp=2)):
            _fleet(pp=2, **kw)
            try:
                fleet.distributed_model(_pipe_layer(
                    [(np.zeros((4, 8)), np.zeros(8)),
                     (np.zeros((8, 4)), np.zeros(4)),
                     (np.zeros((4, 1)), np.zeros(1))], 2)[0])
            except NotImplementedError as e:
                out[next(iter(kw))] = str(e)
        return out
    _fleet(pp=2)
    try:
        fleet.distributed_model(torch.nn.Linear(2, 2))
    except TypeError as e:
        out["plain"] = str(e)
    try:
        fleet.PipelineParallelWithInterleave(None, None)
    except NotImplementedError as e:
        out["interleave"] = str(e)
    return out


def task_sp_layers(w, x):
    """The SP pair on the JAX test's weights (JAX layout), the input
    scattered over the sequence: this rank's output slice, the gathered
    output, the gathered gradients of mean(out^2) (the row bias summed by
    the hook); a LayerNorm marked as a sequence-parallel parameter,
    applied to the sequence slices, summed by its hook."""
    from paddle_tpu_torch.distributed.fleet.mp_layers import gather_full
    from paddle_tpu_torch.distributed.fleet.utils import (
        AllGatherOp, ColumnSequenceParallelLinear, GatherOp,
        RowSequenceParallelLinear, ScatterOp,
        is_sequence_parallel_parameter, mark_as_sequence_parallel_parameter,
        register_sequence_parallel_allreduce_hooks)
    from paddle_tpu_torch.models.convert import local_shard
    _fleet(mp=2)
    col = ColumnSequenceParallelLinear(16, 32, gather_output=False)
    row = RowSequenceParallelLinear(32, 16, input_is_parallel=True)
    with torch.no_grad():
        for layer, k in ((col, "col"), (row, "row")):
            layer.weight.copy_(local_shard(
                torch.from_numpy(w[k + "_w"].T), layer.weight))
            layer.bias.copy_(local_shard(torch.from_numpy(w[k + "_b"]),
                                         layer.bias))
    hooks = register_sequence_parallel_allreduce_hooks(row)
    xt = torch.from_numpy(x)
    out = row(col(ScatterOp.apply(xt, axis=1)))
    (out * out).sum().div(out.numel() * 2).backward()
    res = dict(local=out.detach().numpy(),
               full=GatherOp.apply(out, axis=1).detach().numpy(),
               hooks=len(hooks),
               marked=[is_sequence_parallel_parameter(p) for p in
                       (col.weight, col.bias, row.weight, row.bias)],
               grads=[gather_full(p, p.grad).numpy() for p in
                      (col.weight, col.bias, row.weight, row.bias)])
    ln = torch.nn.LayerNorm(16)
    mark_as_sequence_parallel_parameter(ln.weight)
    mark_as_sequence_parallel_parameter(ln.bias)
    register_sequence_parallel_allreduce_hooks(ln)
    h = ln(ScatterOp.apply(xt, axis=1))
    full = AllGatherOp.apply(h, axis=1)
    (full * torch.arange(16.0)).sum().div(2.0).backward()
    res["ln_grads"] = [ln.weight.grad.numpy(), ln.bias.grad.numpy()]
    return res


TASKS = {k: v for k, v in globals().items() if k.startswith("task_")}


# ----------------------------------------------------------- controller
@pytest.fixture(scope="module")
def worlds():
    ws = {W: World(W, __file__) for W in W_SIZES}
    yield ws
    for w in ws.values():
        w.close()


def _stages(n, seed):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(WIDTH, WIDTH) / np.sqrt(WIDTH))
             .astype(np.float32),
             "b": (rng.randn(WIDTH) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _jax_pipeline(stages, inputs, target, pp, vpp):
    """The JAX package's pipeline (remat on, its default) under
    ``shard_map`` over ``pp`` devices: outputs, and the gradients of the
    mean squared error at the stage parameters and the inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.core.jax_compat import shard_map
    from paddle_tpu.distributed.fleet.spmd_pipeline import (
        interleaved_pipeline_forward, pipeline_forward, stack_stage_params)
    M = inputs.shape[0]
    mesh = Mesh(np.array(jax.devices()[:pp]), ("pp",))
    js = [jax.tree_util.tree_map(jnp.asarray, s) for s in stages]

    def fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])
    if vpp:
        stack = stack_stage_params([stack_stage_params(
            [js[v * pp + r] for r in range(pp)]) for v in range(vpp)])
        spec = jax.tree_util.tree_map(lambda _: P(None, "pp"), stack)

        def run(pl, x):
            local = jax.tree_util.tree_map(lambda a: a[:, 0], pl)
            return interleaved_pipeline_forward(fn, local, x, M, vpp)
    else:
        stack = stack_stage_params(js)
        spec = jax.tree_util.tree_map(lambda _: P("pp"), stack)

        def run(pl, x):
            local = jax.tree_util.tree_map(lambda a: a[0], pl)
            return pipeline_forward(fn, local, x, n_microbatches=M)
    mapped = shard_map(run, mesh=mesh, in_specs=(spec, P()), out_specs=P())

    def loss(pl, x):
        out = mapped(pl, x)
        return jnp.mean((out - target) ** 2), out
    (lv, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stack, jnp.asarray(inputs))
    return float(lv), np.asarray(out), \
        jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)


# (pp, vpp, M): vpp 0 is GPipe (pipeline_forward)
PIPES = [(4, 0, 3), (2, 2, 4), (4, 2, 8), (2, 3, 5)]


_JAX_PIPES = {}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("pp,vpp,M", PIPES)
def test_pipelines_match_the_jax_functions(worlds, pp, vpp, M, remat):
    """The port with remat on and off against the JAX function (whose
    values remat does not change: its own tests hold both to serial)."""
    stages = _stages(pp * max(vpp, 1), seed=3 + pp + vpp)
    rng = np.random.RandomState(M)
    inputs = rng.randn(M, MB, WIDTH).astype(np.float32)
    target = rng.randn(M, MB, WIDTH).astype(np.float32)
    if (pp, vpp, M) not in _JAX_PIPES:
        _JAX_PIPES[pp, vpp, M] = _jax_pipeline(stages, inputs, target, pp,
                                               vpp)
    lv, out, gp, gx = _JAX_PIPES[pp, vpp, M]
    res = worlds[pp].run("task_pipeline", stages, inputs, target, vpp,
                         remat, timeout=TIMEOUT)
    tol = dict(rtol=3e-5, atol=3e-6)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["out"], out, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got["loss"], lv, rtol=2e-5)
        for k in ("w", "b"):
            want = gp[k][:, r] if vpp else gp[k][r]
            np.testing.assert_allclose(got["grads"][k], want, err_msg=k,
                                       **tol)
    # the inputs' gradient: stage 0 reads them, the others see zeros
    np.testing.assert_allclose(sum(g["x_grad"] for g in res), gx, **tol)
    for got in res[1:]:
        assert not got["x_grad"].any()


def test_ring_permute_and_its_reverse(worlds):
    res = worlds[4].run("task_ring", timeout=TIMEOUT)
    for r, (y, g, staged) in enumerate(res):
        assert staged == []
        assert y == [float((r - 1) % 4)] * 3
        # the cotangent 10 + r went back to the sender
        assert g == [10.0 + (r + 1) % 4] * 3


def test_ranks_import_neither_jax_nor_the_jax_package(worlds):
    for w in worlds.values():
        assert w.run("task_modules", timeout=TIMEOUT) == [[]] * w.W


def test_segment_parts_equal_the_jax_ones():
    import paddle_tpu.nn as jnn
    import torch.nn as nn
    from paddle_tpu.distributed.fleet import LayerDesc as JLD
    from paddle_tpu.distributed.fleet import PipelineLayer as JPL
    from paddle_tpu_torch.distributed.fleet import LayerDesc, PipelineLayer

    class Block(nn.Module):
        def forward(self, x):
            return x

    class JBlock(jnn.Layer):
        def forward(self, x):
            return x
    JBlock.__name__ = "Block"
    kinds = "BLBBLBLBBBLB"
    for stages in (1, 2, 3, 4, 5):
        for seg in ("uniform", "layer:Block", "layer:Linear"):
            t = PipelineLayer([LayerDesc(Block) if c == "B" else
                               LayerDesc(nn.Linear, 2, 2) for c in kinds],
                              num_stages=stages, seg_method=seg)
            j = JPL([JLD(JBlock) if c == "B" else JLD(jnn.Linear, 2, 2)
                     for c in kinds], num_stages=stages, seg_method=seg)
            assert t.segment_parts == j.segment_parts, (stages, seg)
            for s in range(stages):
                assert [type(m).__name__ for m in t.get_stage_layers(s)] \
                    == [type(m).__name__ for m in j.get_stage_layers(s)]


def test_layer_descs():
    import torch.nn as nn
    from paddle_tpu_torch.distributed.fleet import (LayerDesc, PipelineLayer,
                                                    SharedLayerDesc)
    pipe = PipelineLayer(layers=[
        SharedLayerDesc("emb", nn.Linear, None, "weight", 4, 4),
        nn.Tanh(), lambda x: x * 2,
        SharedLayerDesc("emb", nn.Linear, None, "weight", 4, 4)],
        num_stages=2)
    layers = list(pipe.run_function)
    assert layers[0] is layers[3] is pipe.get_shared_layer("emb")
    assert len(list(pipe.parameters())) == 2      # one tied weight and bias
    x = torch.randn(3, 4)
    want = layers[0](torch.tanh(layers[0](x)) * 2)
    torch.testing.assert_close(pipe(x), want)
    torch.testing.assert_close(pipe.stage_forward(1, pipe.stage_forward(0, x)),
                               want)
    with pytest.raises(TypeError):
        LayerDesc(lambda: nn.Tanh())
    with pytest.raises(TypeError):
        LayerDesc(nn.Tanh())


def _jax_pipeline_parallel(weights, X, Y, steps, scale):
    import paddle_tpu as paddle
    from paddle_tpu import amp as jamp
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as joptim
    from paddle_tpu.distributed import fleet as jfleet
    import jax.numpy as jnp
    pipe = jfleet.PipelineLayer(
        layers=[jfleet.LayerDesc(jnn.Linear, 4, 8),
                jfleet.LayerDesc(jnn.Tanh),
                jfleet.LayerDesc(jnn.Linear, 8, 4),
                jfleet.LayerDesc(jnn.Linear, 4, 1)],
        num_stages=2, loss_fn=jnn.MSELoss())
    linears = [m for m in pipe.run_function if isinstance(m, jnn.Linear)]
    for m, (w, b) in zip(linears, weights):
        m.weight._value = jnp.asarray(w)
        m.bias._value = jnp.asarray(b)

    class HCG:
        def get_pipe_parallel_world_size(self):
            return 2

        def get_stage_id(self):
            return 0
    strategy = jfleet.DistributedStrategy()
    strategy.pipeline_configs["accumulate_steps"] = 2
    pp = jfleet.PipelineParallel(pipe, HCG(), strategy)
    opt = joptim.SGD(learning_rate=0.05, parameters=pipe.parameters())
    scaler = jamp.GradScaler(init_loss_scaling=scale) if scale else None
    x, y = paddle.to_tensor(X), paddle.to_tensor(Y)
    losses = [float(pp.train_batch((x, y), opt, scaler=scaler).item())
              for _ in range(steps)]
    return dict(losses=losses, eval=float(pp.eval_batch((x, y)).item()),
                weights=[(np.asarray(m.weight._value),
                          np.asarray(m.bias._value)) for m in linears])


@pytest.mark.parametrize("scale", [None, 1024.0])
def test_pipeline_parallel_matches_the_jax_host_schedule(worlds, scale):
    rng = np.random.RandomState(1)
    weights = [((rng.randn(i, o) * 0.5).astype(np.float32),
                (rng.randn(o) * 0.1).astype(np.float32))
               for i, o in ((4, 8), (8, 4), (4, 1))]
    X = rng.randn(8, 4).astype(np.float32)
    Y = X.sum(axis=1, keepdims=True)
    want = _jax_pipeline_parallel(weights, X, Y, 3, scale)
    for got in worlds[2].run("task_pipeline_parallel", weights, X, Y, 3,
                             scale, timeout=TIMEOUT):
        assert got["kind"] == "PipelineParallel"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
        for (gw, gb), (ww, wb) in zip(got["weights"], want["weights"]):
            np.testing.assert_allclose(gw, ww, atol=1e-5)
            np.testing.assert_allclose(gb, wb, atol=1e-5)
    assert want["losses"][-1] < want["losses"][0]


def test_pipeline_refusals(worlds):
    for r in worlds[2].run("task_pp_refusals", timeout=TIMEOUT):
        assert "PipelineLayer" in r["plain"]
        assert "interleaved_pipeline_forward" in r["interleave"]
    for r in worlds[4].run("task_pp_refusals", timeout=TIMEOUT):
        assert "make_hybrid_train_step" in r["dp"]
        assert "make_hybrid_train_step" in r["mp"]


def test_sp_layers_and_hooks_match_the_jax_layers(worlds, hybrid_mesh):
    """``tests/test_sequence_parallel.py``'s SP cases: the column -> row
    pair on a sequence-scattered input against the dense MLP and the JAX
    layers' gradients, the bias marked and summed by its hook; a marked
    LayerNorm on sequence slices summed to the whole gradient."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.utils import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear, ScatterOp)
    rng = np.random.RandomState(0)
    w = {"col_w": (rng.randn(16, 32) * 0.3).astype(np.float32),
         "col_b": (rng.randn(32) * 0.1).astype(np.float32),
         "row_w": (rng.randn(32, 16) * 0.3).astype(np.float32),
         "row_b": (rng.randn(16) * 0.1).astype(np.float32)}
    x = rng.randn(2, 8, 16).astype(np.float32)
    col = ColumnSequenceParallelLinear(16, 32, gather_output=False)
    row = RowSequenceParallelLinear(32, 16, input_is_parallel=True)
    for p, k in ((col.weight, "col_w"), (col.bias, "col_b"),
                 (row.weight, "row_w"), (row.bias, "row_b")):
        p._value = jnp.asarray(w[k])
    out = row(col(ScatterOp.apply(paddle.to_tensor(x), axis=1)))
    paddle.mean(out * out).backward()
    want = np.asarray(out._value)
    dense = (x @ w["col_w"] + w["col_b"]) @ w["row_w"] + w["row_b"]
    np.testing.assert_allclose(want, dense, rtol=2e-4, atol=2e-5)
    want_g = [np.asarray(p.grad._value) for p in (col.weight, col.bias,
                                                  row.weight, row.bias)]
    # a LayerNorm on the whole sequence: the marked parameters' gradient
    import torch.nn as nn
    ln = nn.LayerNorm(16)
    (ln(torch.from_numpy(x)) * torch.arange(16.0)).sum().backward()
    for r, res in enumerate(worlds[2].run("task_sp_layers", w, x,
                                          timeout=TIMEOUT)):
        np.testing.assert_allclose(res["local"], want[:, 4 * r:4 * r + 4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["full"], want, rtol=1e-5, atol=1e-5)
        assert res["hooks"] == 1
        assert res["marked"] == [False, False, False, True]
        for got, ref in zip(res["grads"], want_g):
            got = got.T if got.ndim == 2 else got
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["ln_grads"][0],
                                   ln.weight.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["ln_grads"][1], ln.bias.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    sys.exit(serve(TASKS))
