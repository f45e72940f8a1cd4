"""The port's process groups, collectives, DataParallel and launcher, on
the CPU, against the JAX package.

Each module shares two spawned worlds of CPU ranks over gloo (2 and 4
processes, started once, ``_torch_world.py``): every rank is this file
run as a script (``python tests/test_torch_distributed.py``, which
imports the port and torch, never jax), joined by ``init_parallel_env``
from the launcher's variables, and runs the rank-side task the test
names through the controller's ``TCPStore``.  The JAX package's
collectives run on its 8-virtual-device CPU mesh inside ``shard_map``
(its axis-context mode):
the same rows per rank, the same results; object collectives,
point-to-point calls and barriers, which the JAX package runs through a
multi-process runtime this CPU lacks (``tests/test_eager_comm.py``), are
held against numpy.  ``DataParallel`` reproduces the JAX
``test_dp_training_matches_single_device`` losses at rtol 1e-5 and a
``gpt3_tiny`` AdamW step on the full batch; the launcher runs a 2-rank
script and returns a failing rank's exit code.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_world import ROOT, serve  # noqa: E402
from _torch_world import World as _World  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

W_SIZES = (2, 4)


# ---------------------------------------------------------------- ranks
def _base(r):
    return torch.arange(6, dtype=torch.float32) * (r + 1) + r - 2


def task_modules():
    import paddle_tpu_torch.distributed.fleet.elastic  # noqa: F401
    import paddle_tpu_torch.distributed.launch.main  # noqa: F401
    import paddle_tpu_torch.distributed.rpc  # noqa: F401
    import paddle_tpu_torch.distributed.watchdog  # noqa: F401
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def task_env():
    from paddle_tpu_torch import distributed as dist
    env = dist.ParallelEnv()
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                env_rank=env.rank, nranks=env.nranks,
                endpoint=env.current_endpoint,
                endpoints=env.trainer_endpoints,
                device=str(env.device), backend=dist.get_group().backend,
                initialized=dist.is_initialized())


def _np(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def task_collectives(dev="cpu"):
    """Every collective once, on tensors on ``dev``; results as numpy."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.observability import metrics
    r, W = dist.get_rank(), dist.get_world_size()
    metrics.reset()

    def base(i):
        return _base(i).to(dev)

    def full(shape, v):
        return torch.full(shape, float(v), device=dev)
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        t = base(r)
        dist.all_reduce(t, op)
        out["all_reduce_" + op] = _np(t)
    t = base(r)
    dist.reduce(t, dst=W - 1)
    out["reduce"] = _np(t)
    lst = []
    dist.all_gather(lst, base(r))
    out["all_gather"] = np.stack([_np(x) for x in lst])
    o = torch.empty(6 * W, device=dev)
    dist.all_gather_into_tensor(o, base(r))
    out["all_gather_into_tensor"] = _np(o)
    objs = []
    dist.all_gather_object(objs, {"rank": r, "s": "x" * r})
    out["all_gather_object"] = objs
    x = (torch.arange(2 * W, dtype=torch.float32) * (r + 1)
         + 10 * r).to(dev)
    t = torch.empty(2, device=dev)
    dist.reduce_scatter(t, x)
    out["reduce_scatter"] = _np(t)
    t = torch.empty(2, device=dev)
    dist.reduce_scatter(t, list(x.chunk(W)), op="max")
    out["reduce_scatter_max"] = _np(t)
    ins = [full((3,), 10 * r + j) for j in range(W)]
    outs = []
    dist.alltoall(outs, ins)
    out["alltoall"] = np.stack([_np(x) for x in outs])
    o = torch.empty(2 * W, device=dev)
    dist.alltoall_single(o, (torch.arange(2 * W, dtype=torch.float32)
                             + 100 * r).to(dev))
    out["alltoall_single"] = _np(o)
    t = base(r)
    dist.broadcast(t, src=1)
    out["broadcast"] = _np(t)
    b = base(r).to(torch.bfloat16)
    dist.broadcast(b, src=W - 1)
    out["broadcast_bf16"] = _np(b)
    lst = []
    dist.all_gather(lst, base(r).to(torch.bfloat16))
    out["all_gather_bf16"] = np.stack([_np(x) for x in lst])
    objs = [r, f"from {r}"]
    dist.broadcast_object_list(objs, src=W - 1)
    out["broadcast_object_list"] = objs
    t = torch.empty(3, device=dev)
    dist.scatter(t, [full((3,), j + 100) for j in range(W)]
                 if r == 0 else None, src=0)
    out["scatter"] = _np(t)
    g = []
    dist.gather(base(r), g, dst=0)
    out["gather"] = np.stack([_np(x) for x in g])
    s = dist.isend(base(r), (r + 1) % W)
    t = torch.empty(6, device=dev)
    q = dist.irecv(t, (r - 1) % W)
    s.wait()
    q.wait()
    out["isend_irecv"] = _np(t)
    if r == 0:
        dist.send(torch.tensor([7.0, 8.0], device=dev), 1)
    elif r == 1:
        t = torch.zeros(2, device=dev)
        dist.recv(t, 0)
        out["recv"] = _np(t)
    dist.barrier()
    dist.wait(t)
    g2 = dist.new_group([0, 1])
    t = base(r)
    dist.all_reduce(t, group=g2)
    out["subgroup"] = (_np(t), g2.rank, g2.nranks)
    snap = metrics.snapshot()
    out["calls"] = snap["collective.calls"]
    out["bytes"] = snap["collective.bytes"]
    out["host_staged"] = snap.get("collective.host_staged")
    return out


def task_gloo_cuda_probe():
    """Which of ``torch.distributed``'s own gloo collectives take CUDA
    tensors on this build (the port stages them all through the host)."""
    import torch.distributed as tdist
    W = tdist.get_world_size()
    t = torch.ones(4, device="cuda")
    calls = {
        "all_reduce": lambda: tdist.all_reduce(t.clone()),
        "broadcast": lambda: tdist.broadcast(t.clone(), 0),
        "all_gather": lambda: tdist.all_gather(
            [torch.empty_like(t) for _ in range(W)], t),
        "reduce": lambda: tdist.reduce(t.clone(), 0),
        "reduce_scatter": lambda: tdist.reduce_scatter(
            torch.empty(1, device="cuda"),
            [torch.ones(1, device="cuda") for _ in range(W)]),
        "all_to_all_single": lambda: tdist.all_to_all_single(
            torch.empty(4, device="cuda"), t.clone()),
        "gather": lambda: tdist.gather(
            t.clone(), [torch.empty_like(t) for _ in range(W)]
            if tdist.get_rank() == 0 else None, 0),
        "scatter": lambda: tdist.scatter(
            torch.empty_like(t), [t.clone() for _ in range(W)]
            if tdist.get_rank() == 0 else None, 0)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as e:   # noqa: BLE001 - the probe's answer
            out[name] = f"{type(e).__name__}: {str(e)[:80]}"
        tdist.barrier()
    return out


def task_dp_mlp(init, X, Y, dev="cpu"):
    """The JAX DP test's loop on this rank's half of the batch."""
    import torch.nn as nn
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.optimizer import SGD
    r, W = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 1)).to(dev)
    if r == 0:      # rank 0's weights win: the others start elsewhere
        with torch.no_grad():
            for p, v in zip(net.parameters(), init):
                p.copy_(torch.from_numpy(v))
    model = dist.DataParallel(net)
    opt = SGD(learning_rate=0.1, parameters=net.parameters())
    n = len(X) // W
    x = torch.from_numpy(X[r * n:(r + 1) * n]).to(dev)
    y = torch.from_numpy(Y[r * n:(r + 1) * n]).to(dev)
    losses = []
    for _ in range(5):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        l = loss.detach().clone()
        dist.all_reduce(l, "avg")
        losses.append(float(l))
    return losses


def task_dp_gpt(ids, labels, steps):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.optimizer import AdamW
    r, W = dist.get_rank(), dist.get_world_size()
    model = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=3 + r)
    dp = dist.DataParallel(model, comm_buffer_size=1)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    n = ids.shape[0] // W
    sl = slice(r * n, (r + 1) * n)
    losses = []
    for _ in range(steps):
        loss = dp.compute_loss(torch.from_numpy(ids[sl]),
                               torch.from_numpy(labels[sl]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        l = loss.detach().clone()
        dist.all_reduce(l, "avg")
        losses.append(float(l))
    return losses, {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}


def task_no_sync(X):
    import torch.nn as nn
    from paddle_tpu_torch import distributed as dist
    r = dist.get_rank()
    torch.manual_seed(5)
    net = nn.Linear(4, 2)
    dp = dist.DataParallel(net)
    x = torch.from_numpy(X[r])
    with dp.no_sync():
        dp(x[:2]).sum().backward()
    local = net.weight.grad.numpy().copy()
    dp(x[2:]).sum().backward()              # synchronised: both averaged
    synced = net.weight.grad.numpy().copy()
    net.weight.grad = None
    net.bias.grad = None
    with dp.no_sync():
        dp(x[:2]).sum().backward()
        dp(x[2:]).sum().backward()
    dp.apply_collective_grads()
    return local, synced, net.weight.grad.numpy().copy(), \
        dp.scale_loss(3.0)


def task_sampler(n, bs):
    from paddle_tpu_torch.io import DistributedBatchSampler

    class DS:
        def __len__(self):
            return n
    s = DistributedBatchSampler(DS(), bs, shuffle=True)
    return [list(s), list(s), s.nranks, s.local_rank]


def task_watchdog():
    """``COMM_STATIC_CHECK`` on: a matching all_reduce runs, a mismatched
    all_reduce (rank 1 brings 5 elements) raises on every rank before the
    collective.  Then, the check off: the host waits registered with the
    comm watchdog, and the collectives' counts."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import watchdog as wd
    from paddle_tpu_torch.observability import metrics
    rank = dist.get_rank()
    out = {}
    wd.COMM_STATIC_CHECK = True
    try:
        t = torch.ones(4)
        dist.all_reduce(t)
        out["matched"] = t.tolist()
        bad = torch.ones(5 if rank == 1 else 4)
        try:
            dist.all_reduce(bad)
            out["mismatch"] = None
        except RuntimeError as e:
            out["mismatch"] = str(e)
    finally:
        wd.COMM_STATIC_CHECK = False
    mgr = wd.CommTaskManager.instance()
    seen = len(mgr.history())
    metrics.reset()
    dist.barrier()
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    lst = [rank * 10]
    dist.broadcast_object_list(lst, src=0)
    t = torch.full((2,), float(rank))
    if rank == 0:
        dist.send(t, dst=1)
    elif rank == 1:
        dist.recv(t, src=0)
    dist.all_reduce(t)
    tasks = mgr.history()[seen:]
    out.update(
        objs=objs, lst=lst, t=t.tolist(),
        tasks=[(x.name.split("#")[0], x.meta["rank"], x.meta["generation"],
                type(x.meta["store"]).__name__, x.done, x.error)
               for x in tasks],
        calls={x["labels"]["op"]: x["value"] for x in
               metrics.snapshot()["collective.calls"]["series"]},
        store=type(coll._host_store()).__name__,
        beats=[coll._host_store().check(f"__hb__/0/{r}") for r in range(2)])
    return out


TASKS = {k: v for k, v in globals().items() if k.startswith("task_")}


# ----------------------------------------------------------- controller
# the ranks are this file run as a script (``_torch_world.serve``)
World = functools.partial(_World, script=__file__)


@pytest.fixture(scope="module")
def worlds():
    ws = {W: World(W) for W in W_SIZES}
    yield ws
    for w in ws.values():
        w.close()


def _jax_collectives(W):
    """The JAX package's collectives over a W-device axis of its CPU
    mesh, each rank's row as in ``task_collectives``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import paddle_tpu.distributed as jdist
    from paddle_tpu.core.jax_compat import shard_map
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.framework.tensor import Tensor
    mesh = Mesh(np.array(jax.devices()[:W]), ("w",))
    old = jmesh.get_mesh()
    jmesh.set_mesh(mesh)
    try:
        g = jdist.new_group(axis="w")

        def run(body, rows):
            def worker(x):
                with jdist.axis_context("w"):
                    return body(Tensor._wrap(x[0]))[None]
            f = jax.jit(shard_map(worker, mesh=mesh, in_specs=P("w"),
                                  out_specs=P("w")))
            return np.asarray(f(jnp.asarray(np.stack(rows))))

        base = [_base(r).numpy() for r in range(W)]
        out = {}
        for op in ("sum", "max", "min", "prod", "avg"):
            out["all_reduce_" + op] = run(
                lambda t, op=op: jdist.all_reduce(t, op, group=g)._value,
                base)

        def gather(t):
            lst = []
            jdist.all_gather(lst, t, group=g)
            return jnp.stack([x._value for x in lst])
        out["all_gather"] = run(gather, base)

        def rs(t):
            o = Tensor._wrap(jnp.zeros((2,), jnp.float32))
            return jdist.reduce_scatter(o, t, group=g)._value
        out["reduce_scatter"] = run(rs, [
            np.arange(2 * W, dtype=np.float32) * (r + 1) + 10 * r
            for r in range(W)])

        def a2a(t):
            outs = []
            jdist.alltoall(outs, [Tensor._wrap(t._value[j])
                                  for j in range(W)], group=g)
            return jnp.stack([x._value for x in outs])
        out["alltoall"] = run(a2a, [
            np.stack([np.full(3, 10 * r + j, np.float32) for j in range(W)])
            for r in range(W)])
        out["broadcast"] = run(
            lambda t: jdist.broadcast(t, src=1, group=g)._value, base)
        return out
    finally:
        jmesh.set_mesh(old)


@pytest.mark.parametrize("W", W_SIZES)
def test_collectives_match_the_jax_package(worlds, W):
    got = worlds[W].run("task_collectives")
    want = _jax_collectives(W)
    base = np.stack([_base(r).numpy() for r in range(W)])
    for r, res in enumerate(got):
        for key, val in want.items():
            np.testing.assert_allclose(res[key], val[r], rtol=1e-6,
                                       err_msg=f"{key} rank {r}")
        np.testing.assert_allclose(res["reduce"], base.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(res["all_gather_into_tensor"],
                                      base.reshape(-1))
        assert res["all_gather_object"] == [{"rank": i, "s": "x" * i}
                                             for i in range(W)]
        x = np.stack([np.arange(2 * W, dtype=np.float32) * (i + 1) + 10 * i
                      for i in range(W)])
        np.testing.assert_array_equal(res["reduce_scatter_max"],
                                      x.max(0)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["alltoall_single"],
                                      np.array([[2 * r + j * 100.0,
                                                 2 * r + 1 + j * 100.0]
                                                for j in range(W)]).ravel())
        bf = torch.from_numpy(base).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(res["broadcast_bf16"], bf[W - 1])
        np.testing.assert_array_equal(res["all_gather_bf16"], bf)
        assert res["broadcast_object_list"] == [W - 1, f"from {W - 1}"]
        np.testing.assert_array_equal(res["scatter"], np.full(3, r + 100.0))
        np.testing.assert_array_equal(res["gather"], base)
        np.testing.assert_array_equal(res["isend_irecv"],
                                      base[(r - 1) % W])
        if r == 1:
            np.testing.assert_array_equal(res["recv"], [7.0, 8.0])
        sub, grank, gsize = res["subgroup"]
        if r < 2:
            np.testing.assert_allclose(sub, base[:2].sum(0))
            assert (grank, gsize) == (r, 2)
        else:
            np.testing.assert_array_equal(sub, base[r])
            assert grank == -1
        calls = {x["labels"]["op"]: x["value"]
                 for x in res["calls"]["series"]}
        assert calls["all_reduce"] >= 7 and calls["barrier"] == 1
        assert {x["labels"]["op"] for x in res["bytes"]["series"]} >= {
            "all_reduce", "all_gather", "broadcast", "alltoall"}


def test_ranks_import_neither_jax_nor_the_jax_package(worlds):
    for w in worlds.values():
        assert w.run("task_modules") == [[]] * w.W


def test_static_check_and_the_watchdog_in_a_world(worlds):
    """With ``COMM_STATIC_CHECK`` a mismatched ``all_reduce`` raises on
    both ranks, naming rank 1 and the two metas as the JAX package's
    check does, before the collective (a matched one sums as ever); the
    barrier, the object collectives and the receive's wait are comm
    tasks with the job's store and generation in their meta, and every
    rank's heartbeat is on that store; with the
    check off the ``collective.calls`` counts are one a call."""
    texts = {0: "comm_static_check failed for 'all_reduce' seq 1: rank 1 "
                "brings {'shape': [5], 'dtype': 'float32'}, rank 0 brings "
                "{'shape': [4], 'dtype': 'float32'}",
             1: "comm_static_check failed for 'all_reduce' seq 1: rank 1 "
                "meta {'shape': [5], 'dtype': 'float32'} != rank 0 meta "
                "{'shape': [4], 'dtype': 'float32'}"}
    for r, res in enumerate(worlds[2].run("task_watchdog")):
        assert res["matched"] == [2.0] * 4
        assert res["mismatch"] == texts[r]
        assert res["objs"] == [{"rank": 0}, {"rank": 1}]
        assert res["lst"] == [0] and res["t"] == [0.0, 0.0]
        names = ["barrier", "all_gather_object", "broadcast_object_list"]
        if r == 1:
            names.append("recv(0->1)")
        assert [x[0] for x in res["tasks"]] == names
        for _, rank, gen, store, done, error in res["tasks"]:
            assert (rank, gen, store, done, error) == (r, "0", "TCPStore",
                                                       True, None)
        assert res["store"] == "TCPStore"
        assert res["beats"] == [True, True]     # init_parallel_env's
        assert res["calls"] == {"barrier": 1, "all_gather_object": 1,
                                "broadcast_object_list": 1,
                                "send" if r == 0 else "recv": 1,
                                "all_reduce": 1}


def test_env_from_the_launcher_variables(worlds):
    W = 4
    for r, e in enumerate(worlds[W].run("task_env")):
        assert (e["rank"], e["world"], e["env_rank"], e["nranks"]) == \
            (r, W, r, W)
        assert e["endpoint"] == f"127.0.0.1:{7000 + r}"
        assert e["endpoints"] == [f"127.0.0.1:{7000 + i}" for i in range(W)]
        assert e["device"] == "cpu" and e["backend"] == "gloo"
        assert e["initialized"]


def test_single_rank_defaults(monkeypatch):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.parallel import choose_backend
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    monkeypatch.delenv("PADDLE_TRAINERS_NUM", raising=False)
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    t = torch.ones(3)
    assert dist.all_reduce(t) is t and t.tolist() == [1, 1, 1]
    lst = []
    dist.all_gather(lst, t)
    assert lst == [t]
    d = torch.device
    assert choose_backend([d("cuda", 0), d("cuda", 1)]) == "nccl"
    assert choose_backend([d("cuda", 0), d("cuda", 0)]) == "gloo"
    assert choose_backend([d("cpu"), d("cpu")]) == "gloo"


def test_distributed_sampler_from_the_environment(worlds):
    from paddle_tpu import io as jio

    class DS:
        def __len__(self):
            return 13
    for r, (e1, e2, nr, lr) in enumerate(worlds[4].run("task_sampler", 13,
                                                        3)):
        assert (nr, lr) == (4, r)
        j = jio.DistributedBatchSampler(DS(), 3, num_replicas=4, rank=r,
                                        shuffle=True)
        assert e1 == list(j) and e2 == list(j)


def test_dp_training_matches_single_device(worlds):
    """The JAX ``test_dp_training_matches_single_device`` numbers from a
    2-rank ``DataParallel``: the JAX net's initial weights (rank 0's; the
    other rank starts from its own and is overwritten by the broadcast),
    each rank on half the batch."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn, optimizer as jopt
    paddle.seed(9)
    net = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 1))
    init = [np.asarray(p._value).T.copy() if p._value.ndim == 2
            else np.asarray(p._value).copy() for p in net.parameters()]
    opt = jopt.SGD(learning_rate=0.1, parameters=net.parameters())
    X = np.random.RandomState(0).rand(16, 4).astype("float32")
    Xt = paddle.to_tensor(X)
    Y = Xt.sum(axis=1, keepdim=True)
    want = []
    for _ in range(5):
        loss = jnn.MSELoss()(net(Xt), Y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.item()))
    got = worlds[2].run("task_dp_mlp", init, X,
                        X.sum(axis=1, keepdims=True))
    for losses in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_dp_adamw_step_matches_one_process(worlds):
    """``gpt3_tiny``, two AdamW steps under ``DataParallel`` on 2 ranks
    (each its half of the batch; rank 1 built from another seed, so the
    broadcast matters) against one process on the whole batch."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.optimizer import AdamW
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 1024, (4, 16)).astype(np.int64)
    labels = rng.randint(0, 1024, (4, 16)).astype(np.int64)
    model = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=3)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    want = []
    for _ in range(2):
        loss = model.compute_loss(torch.from_numpy(ids),
                                  torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.detach()))
    ref = model.state_dict()
    # parameters within 2 lr a step (ROADMAP.md reference fact 6: a
    # gradient that is zero up to rounding, as the key bias's is, takes a
    # step of about lr either way under Adam's normalisation)
    for losses, state in worlds[2].run("task_dp_gpt", ids, labels, 2):
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        for k, v in ref.items():
            np.testing.assert_allclose(state[k], v.numpy(), rtol=0,
                                       atol=2 * 1e-3 * 2, err_msg=k)


def test_no_sync_accumulates_locally(worlds):
    X = np.random.RandomState(2).rand(2, 4, 4).astype(np.float32)
    for r, (local, synced, applied, scaled) in enumerate(
            worlds[2].run("task_no_sync", X)):
        # d(sum of y)/dW: each output row is the sum of the inputs
        np.testing.assert_allclose(local, np.tile(X[r, :2].sum(0), (2, 1)),
                                   rtol=1e-6)
        want = np.tile(X.sum(1).mean(0), (2, 1))
        np.testing.assert_allclose(synced, want, rtol=1e-6)
        np.testing.assert_allclose(applied, want, rtol=1e-6)
        assert scaled == 3.0


SCRIPT = r"""
import sys, torch
from paddle_tpu_torch import distributed as dist
env = dist.init_parallel_env()
t = torch.tensor([float(env.rank + 1)])
dist.all_reduce(t)
print("rank", env.rank, "of", env.world_size, "sum", t.item(), flush=True)
if env.rank == int(sys.argv[1]):
    sys.exit(7)
"""


def test_launch_runs_a_script_and_returns_the_failing_code(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def launch(fail, logs):
        # graft-lint: disable=R010 (two CPU ranks of a 7-line script, twice; ~13 s measured; the launcher's subject is processes)
        return subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", "--devices", "cpu", "--log_dir",
             str(logs), str(script), str(fail)], env=env, cwd=tmp_path,
            capture_output=True, timeout=120)
    ok = launch(-1, tmp_path / "ok")
    assert ok.returncode == 0, ok.stderr.decode()
    for r in range(2):
        text = (tmp_path / "ok" / f"default.rank{r}.log").read_text()
        assert f"rank {r} of 2 sum 3.0" in text
    bad = launch(1, tmp_path / "bad")
    assert bad.returncode == 7
    assert "rank 1 exited with code 7" in bad.stderr.decode()
    assert "rank 1 of 2 sum 3.0" in (tmp_path / "bad" /
                                     "default.rank1.log").read_text()


def test_launch_without_cards_needs_named_devices():
    import torch.cuda
    from paddle_tpu_torch.distributed.launch import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ValueError, match="--devices"):
        main._rank_devices(None, 2)
    assert main._rank_devices("0,0", 2) == ["0", "0"]
    assert main._rank_devices("cpu", 3) == ["cpu"] * 3


if __name__ == "__main__":
    sys.exit(serve(TASKS))
