"""The port's distributed checkpoints (``distributed/checkpoint/``: sharded
save, reshard-on-load, ``CheckpointManager``) and the resumes built on
them (the hybrid and ZeRO-3 steps' save / load, ``hapi.Model.fit``), on
the CPU, against the JAX package.

The ranks are forked worlds of 2 and 4 CPU processes over gloo
(``_torch_world.py``); they import the port and torch, never jax.  The
JAX side runs in the controller on its 8-virtual-device mesh, through its
save / load functions only (its resume tests over the ``shard_map`` step
programs are its slow tier).  A piece of a global tensor is a rank's
``ShardedLeaf``.  Loads are exact (the bytes of the saved values); every
resume is bit-equal to the uninterrupted run.
"""

import os
import signal
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_world import ROOT, World, serve  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

W_SIZES = (2, 4)
TIMEOUT = 120
# the JAX fault-tolerance test's model (tests/test_fault_tolerance.py:513)
SMALL = dict(num_layers=2, n_microbatches=2, hidden_size=32, vocab_size=64,
             seq_len=16, num_heads=4)
ROWS = 4                      # rows of a micro-batch
HYBRID_LAYOUTS = [(1, 2, 2), (2, 2, 1)]     # (pp, dp, mp) on 4 ranks


# ---------------------------------------------------------------- ranks
def task_modules():
    import paddle_tpu_torch.distributed.fleet.elastic  # noqa: F401
    import paddle_tpu_torch.distributed.launch.main  # noqa: F401
    import paddle_tpu_torch.distributed.rpc  # noqa: F401
    import paddle_tpu_torch.distributed.watchdog  # noqa: F401
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def _fleet(pp=1, dp=1, mp=1):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                            sharding_degree=1, sep_degree=1)
    return fleet.init(is_collective=True, strategy=s)


def _grid_piece(arr, grid, rank):
    """Rank ``rank``'s block of ``arr`` on a row-major grid of parts."""
    coords = np.unravel_index(rank, grid)
    sl, off = [], []
    for n, parts, c in zip(arr.shape, grid, coords):
        k = n // parts
        sl.append(slice(c * k, (c + 1) * k))
        off.append(c * k)
    return arr[tuple(sl)], off


def task_save_grid(root, arrays, grids, whole):
    """Save each array of ``arrays`` as this rank's block on its grid of
    ``grids`` (a ``ShardedLeaf``), beside the whole tensors ``whole``."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (ShardedLeaf,
                                                         save_state_dict)
    rank = dist.get_rank()
    sd = {"whole": {k: torch.from_numpy(v) for k, v in whole.items()}}
    for k, a in arrays.items():
        block, off = _grid_piece(a, grids[k], rank)
        sd[k] = ShardedLeaf(torch.from_numpy(block.copy()), a.shape, off)
    save_state_dict(sd, root)
    dist.barrier()
    return sorted(os.listdir(root))


def task_load_grid(root, shapes, grids):
    """Load each key into this rank's block on its grid of ``grids``."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (ShardedLeaf,
                                                         load_state_dict)
    rank = dist.get_rank()
    sd = {}
    for k, shape in shapes.items():
        block, off = _grid_piece(np.zeros(shape, np.float32), grids[k], rank)
        sd[k] = ShardedLeaf(torch.zeros(block.shape), shape, off)
    load_state_dict(sd, root)
    return {k: (leaf.global_offset, leaf.local.numpy())
            for k, leaf in sd.items()}


def _local_moment(g, spec, coords):
    """A rank's flat ZeRO slice of a JAX global moment: ``(sizes(A)...,
    Fp)`` over the spec's axes A, indexed by the rank's coordinates."""
    for a in spec:
        if a is not None:
            g = g[coords[a]]
    k = g.shape[0] // coords["dp_size"]
    return g[coords["dp"] * k:(coords["dp"] + 1) * k]


def _coords(hcg):
    return {"pp": hcg.get_stage_id(), "dp": hcg.get_data_parallel_rank(),
            "mp": hcg.get_model_parallel_rank(),
            "dp_size": hcg.get_data_parallel_world_size()}


def task_hybrid_io(jax_root, port_root, cfg_kw, stacked, m, v):
    """At the layout of ``cfg_kw``: load the JAX package's version at
    ``jax_root`` into fresh templates (``load_hybrid_state``), then save
    this rank's share of the global trees ``stacked`` / ``m`` / ``v``
    under ``port_root`` (``save_hybrid_state``)."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import (hybrid_params_from_numpy,
                                                 hybrid_params_to_numpy)
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(cfg.pp, cfg.dp, cfg.mp)
    c = _coords(hcg)

    def local_params(tree):
        return T.hybrid_local_params(tree, cfg, c["pp"], c["mp"], c["dp"])
    tmpl = local_params(T.stack_for_pipeline(T.init_gpt_params(cfg), cfg))
    tm, tv, _ = T.init_zero_state(tmpl, T.hybrid_param_specs(cfg), cfg.dp)
    p, lm, lv, step_no = T.load_hybrid_state(CheckpointManager(jax_root),
                                             hcg, cfg, tmpl, tm, tv)
    loaded = [hybrid_params_to_numpy(t) for t in (p, lm, lv)]
    # the same state, saved by the port's ranks
    specs = T.flatten(T.hybrid_param_specs(cfg))[0]

    def moments(tree):
        leaves, treedef = T.flatten(tree)
        return T.unflatten(treedef, [
            torch.from_numpy(np.ascontiguousarray(_local_moment(g, s, c)))
            for g, s in zip(leaves, specs)])
    mgr = CheckpointManager(port_root, async_save=True)
    T.save_hybrid_state(mgr, 3,
                        local_params(hybrid_params_from_numpy(stacked)),
                        moments(m), moments(v), step_no, cfg=cfg, hcg=hcg)
    mgr.wait()
    coll.barrier()
    return c, step_no, loaded


def task_zero3_io(jax_root, port_root, cfg_kw):
    """Load the JAX package's ZeRO-3 version (``load_zero3_state`` at this
    world's dp), then save it again under ``port_root``."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(dp=cfg.dp)
    fp, m, v, step_no, grain = T.load_zero3_state(
        CheckpointManager(jax_root), hcg, cfg)
    out = [[t.numpy().copy() for t in T.flatten(x)[0]] for x in (fp, m, v)]
    mgr = CheckpointManager(port_root)
    T.save_zero3_state(mgr, 5, fp, m, v, step_no, grain, cfg=cfg, hcg=hcg)
    coll.barrier()
    return hcg.get_data_parallel_rank(), step_no, grain, out


def _digest(tree):
    import hashlib

    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    h = hashlib.sha256()
    for t in T.flatten(tree)[0]:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def task_hybrid_resume(root, cfg_kw, ids):
    """The hybrid step at this layout: 4 steps uninterrupted; then 2
    steps, an async save of the state, fresh templates restored, and 2
    more.  Returns both runs' losses and gathered trees' digests, and the
    restored state's digest against the saved one's."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(cfg.pp, cfg.dp, cfg.mp)
    step = T.make_hybrid_train_step(hcg, cfg)
    ids = torch.from_numpy(ids)

    def fresh():
        local = T.hybrid_local_params(
            T.stack_for_pipeline(T.init_gpt_params(cfg), cfg), cfg,
            hcg.get_stage_id(), hcg.get_model_parallel_rank(),
            hcg.get_data_parallel_rank())
        return (local,) + T.init_zero_state(
            local, T.hybrid_param_specs(cfg), cfg.dp)[:2]

    def run(state, first, n):
        losses = []
        for i in range(first, first + n):
            loss, *state = step(*state, float(i + 1), ids)
            losses.append(float(loss))
        return state, losses

    state, ref = run(fresh(), 0, 4)
    want = _digest(T.gather_hybrid_params(state[0], cfg, hcg))
    state, got = run(fresh(), 0, 2)
    saved = _digest({"p": state[0], "m": state[1], "v": state[2]})
    mgr = CheckpointManager(root, async_save=True)
    T.save_hybrid_state(mgr, 2, *state, 2.0, cfg=cfg, hcg=hcg)
    state = None            # the snapshot owns its bytes
    mgr.wait()
    coll.barrier()          # the coordinator has committed
    *state, step_no = T.load_hybrid_state(CheckpointManager(root), hcg, cfg,
                                          *fresh())
    restored = _digest({"p": state[0], "m": state[1], "v": state[2]})
    state, more = run(state, int(step_no), 2)
    return dict(ref=ref, got=got + more, want=want, saved=saved,
                restored=restored, step_no=step_no,
                have=_digest(T.gather_hybrid_params(state[0], cfg, hcg)))


def task_zero3_segment(root, cfg_kw, params, ids, first, n, load, save):
    """ZeRO-3 at grain 4 on this world's dp: from the serial ``params``
    (``load`` None) or the version ``load`` of ``root``, run steps
    ``first + 1 .. first + n``, then save them as version ``save`` (if
    given).  Returns the losses and the whole flat leaves of params, m and
    v (the ranks' slices concatenated)."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_from_numpy
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(dp=cfg.dp)
    if load is None:
        state = T.init_zero3_state(hybrid_params_from_numpy(params), cfg.dp,
                                   hcg.get_data_parallel_rank())
    else:
        *state, step_no, grain = T.load_zero3_state(
            CheckpointManager(root), hcg, cfg, step=load)
        assert (step_no, grain) == (float(first), 4)
    step = T.make_zero3_train_step(hcg, cfg, grain=4)
    losses = []
    for i in range(first, first + n):
        loss, *state = step(*state, float(i + 1), torch.from_numpy(ids))
        losses.append(float(loss))
    if save is not None:
        T.save_zero3_state(CheckpointManager(root), save, *state,
                           float(first + n), 4, wait=True, cfg=cfg, hcg=hcg)
        coll.barrier()
    g = hcg.get_data_parallel_group()
    whole = [[coll.all_gather_concat(t, 0, g).numpy()
              for t in T.flatten(x)[0]] for x in state]
    return losses, whole


class _Killed(Exception):
    pass


def task_zero3_hooks_cold(cfg_kw, params):
    """``zero3_elastic_hooks``' cold start against ``init_zero3_state``."""
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.distributed.fleet.elastic import (
        ElasticContext, zero3_elastic_hooks)
    from paddle_tpu_torch.models.convert import hybrid_params_from_numpy
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(dp=cfg.dp)
    init_fn, _, _ = zero3_elastic_hooks(
        hcg, cfg, lambda ctx: hybrid_params_from_numpy(params), grain=2)
    state, step = init_fn(ElasticContext.from_env())
    want = T.init_zero3_state(hybrid_params_from_numpy(params), cfg.dp,
                              hcg.get_data_parallel_rank())
    same = all(a.numpy().tobytes() == b.numpy().tobytes()
               for name, tree in zip(("flat", "m", "v"), want)
               for a, b in zip(T.flatten(state[name])[0],
                               T.flatten(tree)[0]))
    return step, state["step_no"], state["grain"], same


def task_zero3_hooks_restore(root, cfg_kw):
    """``restore_fn`` of ``zero3_elastic_hooks`` at this world's dp: this
    rank's slices and the step it resumes at."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.distributed.fleet.elastic import (
        ElasticContext, zero3_elastic_hooks)
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(dp=cfg.dp)
    _, restore_fn, _ = zero3_elastic_hooks(hcg, cfg, None, grain=4)
    state, step = restore_fn(CheckpointManager(root),
                             ElasticContext.from_env())
    return (hcg.get_data_parallel_rank(), step, state["step_no"],
            state["grain"], [[t.numpy().copy() for t in T.flatten(
                state[k])[0]] for k in ("flat", "m", "v")])


def task_zero3_elastic(root, cfg_kw, params, ids, generation, die_at):
    """``run_elastic`` over ``zero3_elastic_hooks`` at grain 2 to step 4,
    a save every 2 steps; generation 0 dies after ``die_at`` steps
    (None: never).  The losses by step and the whole flat leaves at the end."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.distributed.fleet.elastic import (
        ElasticContext, run_elastic, zero3_elastic_hooks)
    from paddle_tpu_torch.models.convert import hybrid_params_from_numpy
    from paddle_tpu_torch.observability import metrics
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(dp=cfg.dp)
    hooks = zero3_elastic_hooks(
        hcg, cfg, lambda ctx: hybrid_params_from_numpy(params), grain=2)
    step = T.make_zero3_train_step(hcg, cfg, grain=2)
    ids = torch.from_numpy(ids)
    losses = {}

    def step_fn(state, i, ctx):
        if ctx.generation == 0 and i == die_at:
            raise _Killed()
        loss, *st = step(state["flat"], state["m"], state["v"],
                         float(i + 1), ids)
        losses[i + 1] = float(loss)
        return dict(zip(("flat", "m", "v"), st), step_no=float(i + 1),
                    grain=state["grain"])
    ctx = dict(ElasticContext.from_env().__dict__, generation=generation,
               master=None)
    metrics.reset()
    try:
        state, steps = run_elastic(
            step_fn, CheckpointManager(root, keep_last=4), init_fn=hooks[0],
            restore_fn=hooks[1], save_fn=hooks[2], max_steps=4,
            save_every=2, ctx=ElasticContext(**ctx))
    except _Killed:
        coll.barrier()
        return dict(killed=True, losses=losses)
    g = hcg.get_data_parallel_group()
    whole = [[coll.all_gather_concat(t, 0, g).numpy()
              for t in T.flatten(state[k])[0]] for k in ("flat", "m", "v")]
    resumes = metrics.get("elastic.resumes_total")
    return dict(killed=False, losses=losses, steps=steps, whole=whole,
                resumes=0 if resumes is None else resumes.total())


TASKS = {k: v for k, v in globals().items() if k.startswith("task_")}


# ----------------------------------------------------------- controller
@pytest.fixture(scope="module")
def worlds():
    ws = {W: World(W, __file__) for W in W_SIZES}
    yield ws
    for w in ws.values():
        w.close()


@pytest.fixture(autouse=True)
def _clean_slate():
    from paddle_tpu_torch.distributed.checkpoint import manager
    from paddle_tpu_torch.observability import flight_recorder as flight
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.testing import chaos
    metrics.reset()
    flight.default_recorder().clear()
    manager.clear_preemption()
    yield
    manager.clear_preemption()
    assert chaos.active_faults() == 0


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {".".join(prefix): tree}


def test_helpers_equal_the_jax_functions():
    from paddle_tpu.distributed.checkpoint import utils as J
    from paddle_tpu_torch.distributed.checkpoint import utils as T
    sd = {"model": {"fc.w": 1, "b": {"c": 2}}, "x": 3}
    assert T.flatten_state_dict(sd) == J.flatten_state_dict(sd)
    flat, mapping = J.flatten_state_dict(sd)
    assert T.unflatten_state_dict(flat, mapping) == sd
    with pytest.raises(ValueError, match="duplicate"):
        T.flatten_state_dict({"a.b": 1, "a": {"b": 2}})
    idx = (slice(4, 8), slice(None, 2))
    assert T.offset_of(idx, (8, 8)) == J.offset_of(idx, (8, 8)) == (4, 0)
    src = np.arange(24, dtype=np.float32).reshape(4, 6)
    for dst_off, src_off in (((0, 0), (2, 3)), ((1, 1), (0, 0)),
                             ((5, 0), (0, 0))):
        a, b = np.zeros((3, 4), np.float32), np.zeros((3, 4), np.float32)
        assert T.copy_intersection(a, dst_off, src, src_off) == \
            J.copy_intersection(b, dst_off, src, src_off)
        np.testing.assert_array_equal(a, b)


def test_round_trips_in_one_process(tmp_path):
    """The JAX ``test_replicated_round_trip`` and
    ``test_nested_flatten_round_trip``, and bfloat16's words."""
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         read_state_dict,
                                                         save_state_dict)
    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    sd = {"w": torch.from_numpy(w), "b": torch.ones(3),
          "model": {"fc.w": torch.ones(2, 2)},
          "opt": {"moment1": {"fc.w": torch.full((2, 2), 3.0)}},
          "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    save_state_dict(sd, str(tmp_path))
    target = {"w": torch.zeros(4, 8), "b": torch.zeros(3),
              "model": {"fc.w": torch.zeros(2, 2)},
              "opt": {"moment1": {"fc.w": torch.zeros(2, 2)}},
              "h": torch.zeros(2, dtype=torch.bfloat16)}
    load_state_dict(target, str(tmp_path))
    for k, want in _flat(sd).items():
        got = _flat(target)[k]
        assert got.dtype == want.dtype and torch.equal(got, want), k
    out = read_state_dict(str(tmp_path))
    np.testing.assert_array_equal(out["w"], w)
    np.testing.assert_array_equal(out["opt"]["moment1"]["fc.w"], 3.0)
    np.testing.assert_array_equal(out["h"], np.float32([1.5, -2.25]))


def test_errors_as_the_jax_package_raises(tmp_path):
    """Missing keys, a shape mismatch, an incomplete set of pieces, a
    stored dtype unlike the recorded one, no directory, no metadata, and
    the stale metadata a crashed save would leave."""
    import pickle

    from paddle_tpu_torch.distributed.checkpoint import (ShardedLeaf,
                                                         load_state_dict,
                                                         save_state_dict)
    from paddle_tpu_torch.testing import chaos
    path = str(tmp_path / "a")
    save_state_dict({"a": torch.ones(2, 3)}, path)
    with pytest.raises(KeyError, match="nope"):
        load_state_dict({"nope": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state_dict({"a": torch.zeros(3, 2)}, path)
    half = str(tmp_path / "half")
    save_state_dict({"a": ShardedLeaf(torch.ones(1, 3), (2, 3), (0, 0))},
                    half)
    with pytest.raises(ValueError, match="cover 3/6 elements"):
        load_state_dict({"a": torch.zeros(2, 3)}, half)
    with open(os.path.join(path, "0.metadata"), "rb") as f:
        md = pickle.load(f)
    md.state_dict_metadata["a"][0].dtype = "float64"
    with open(os.path.join(path, "0.metadata"), "wb") as f:
        pickle.dump(md, f)
    with pytest.raises(ValueError, match="checkpoint corruption"):
        load_state_dict({"a": torch.zeros(2, 3)}, path)
    with pytest.raises(FileNotFoundError, match="nope"):
        load_state_dict({"a": torch.zeros(2)}, str(tmp_path / "nope"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="no .metadata"):
        load_state_dict({"a": torch.zeros(2)}, str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="inside the global shape"):
        ShardedLeaf(torch.ones(2, 3), (2, 3), (1, 0))
    crash = str(tmp_path / "crash")
    save_state_dict({"a": torch.ones(4)}, crash)
    with chaos.fail_open(".metadata", on_calls=[1]):
        with pytest.raises(OSError):
            save_state_dict({"a": torch.full((4,), 2.0)}, crash)
    with pytest.raises(ValueError, match="no .metadata"):
        load_state_dict({"a": torch.zeros(4)}, crash)


def test_pieces_of_a_world_load_in_another_world_size(worlds, tmp_path):
    """Row blocks over 4 ranks load as column blocks over 2, a 2 x 2 grid
    as the other dimension's blocks, and both whole; a whole tensor is
    written by rank 0 alone (the JAX ``test_sharded_save_resharded_load``,
    ``test_2d_sharded_to_2d_sharded``, ``test_read_state_dict_full_
    assembly``)."""
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         read_state_dict)
    arrays = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
              "w2": np.arange(128, dtype=np.float32).reshape(16, 8)}
    whole = {"b": np.ones(3, np.float32)}
    root = str(tmp_path)
    files = worlds[4].run("task_save_grid", root, arrays,
                          {"w": (4, 1), "w2": (2, 2)}, whole,
                          timeout=TIMEOUT)[0]
    assert files == sorted([f"{r}.metadata" for r in range(4)]
                           + [f"{r}_0.distcp" for r in range(4)])
    shapes = {k: a.shape for k, a in arrays.items()}
    res = worlds[2].run("task_load_grid", root, shapes,
                        {"w": (1, 2), "w2": (2, 1)}, timeout=TIMEOUT)
    for got in res:
        for k, (off, block) in got.items():
            sl = tuple(slice(o, o + n) for o, n in zip(off, block.shape))
            np.testing.assert_array_equal(block, arrays[k][sl])
    target = {k: torch.zeros(a.shape) for k, a in arrays.items()}
    load_state_dict(target, root)
    for k, a in arrays.items():
        np.testing.assert_array_equal(target[k].numpy(), a)
    out = read_state_dict(root)
    for k, a in arrays.items():
        np.testing.assert_array_equal(out[k], a)
    np.testing.assert_array_equal(out["whole"]["b"], whole["b"])
    z = np.load(os.path.join(root, "1_0.distcp"))
    assert sorted(z.files) == ["w2|0", "w|0"]       # b is rank 0's


# ------------------------------------------ versions of the JAX package

def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda x: np.asarray(x).copy(), tree)


@pytest.fixture(scope="module", params=HYBRID_LAYOUTS,
                ids=lambda l: "pp%d_dp%d_mp%d" % l)
def hybrid_versions(request, worlds, tmp_path_factory):
    """At one (pp, dp, mp) layout on 4 devices: the JAX package's
    ``save_hybrid_state`` of seeded parameters and random moments, the
    port's ranks' load of it and their save of the same state, and both
    packages' ``read_state_dict`` of their versions."""
    import jax
    from paddle_tpu.distributed.checkpoint import CheckpointManager as JM
    from paddle_tpu.distributed.checkpoint import read_state_dict as jread
    from paddle_tpu.distributed.fleet import hybrid_step as J
    from paddle_tpu_torch.distributed.checkpoint import read_state_dict
    pp, dp, mp = request.param
    cfg_kw = dict(SMALL, pp=pp, dp=dp, mp=mp)
    cfg = J.HybridConfig(**cfg_kw)
    mesh = _jax_mesh((pp, dp, mp), ("pp", "dp", "mp"))
    stacked = J.stack_for_pipeline(J.init_gpt_params(jax.random.key(7), cfg),
                                   cfg)
    specs = J.hybrid_param_specs(cfg)
    m0, _, opt_specs = J.init_zero_state(stacked, specs, mesh)
    rng = np.random.RandomState(sum(request.param))
    m = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), m0)
    v = jax.tree_util.tree_map(
        lambda x: np.abs(rng.standard_normal(x.shape)).astype(np.float32), m0)
    base = tmp_path_factory.mktemp("hybrid")
    jax_root, port_root = str(base / "jax"), str(base / "port")
    J.save_hybrid_state(JM(jax_root), 3, J._shard_tree(stacked, specs, mesh),
                        J._shard_tree(m, opt_specs, mesh),
                        J._shard_tree(v, opt_specs, mesh), 3.0)
    stacked = _np_tree(stacked)
    ranks = worlds[4].run("task_hybrid_io", jax_root, port_root, cfg_kw,
                          stacked, m, v, timeout=TIMEOUT)
    step = os.path.join(port_root, "step_00000003")
    return dict(cfg_kw=cfg_kw, stacked=stacked, m=m, v=v, ranks=ranks,
                jax=jread(os.path.join(jax_root, "step_00000003")),
                port=read_state_dict(step), port_step=step)


def test_the_port_loads_the_jax_packages_hybrid_versions(hybrid_versions):
    """Every rank's restored templates are exactly ``hybrid_local_params``
    of the saved tree, and its moments its slices of the global ones."""
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_from_numpy
    hv = hybrid_versions
    cfg = T.HybridConfig(**hv["cfg_kw"])
    specs = T.flatten(T.hybrid_param_specs(cfg))[0]
    stacked = hybrid_params_from_numpy(hv["stacked"])
    for c, step_no, (p, m, v) in hv["ranks"]:
        assert step_no == 3.0
        want = T.hybrid_local_params(stacked, cfg, c["pp"], c["mp"], c["dp"])
        for a, b in zip(T.flatten(p)[0], T.flatten(want)[0]):
            assert a.shape == tuple(b.shape)
            assert a.tobytes() == b.numpy().tobytes()
        for got, glob in ((m, hv["m"]), (v, hv["v"])):
            for a, g, s in zip(T.flatten(got)[0], T.flatten(glob)[0],
                               specs):
                w = _local_moment(g, s, c)
                assert a.tobytes() == np.ascontiguousarray(w).tobytes()


def test_the_port_writes_what_the_jax_package_writes(hybrid_versions):
    """The port's version of the same state assembles to the JAX
    version's flat keys, global shapes, dtypes and values."""
    hv = hybrid_versions
    jf, pf = _flat(hv["jax"]), _flat(hv["port"])
    assert sorted(jf) == sorted(pf)
    for k, a in jf.items():
        b = pf[k]
        assert (b.shape, b.dtype) == (a.shape, a.dtype), k
        assert b.tobytes() == a.tobytes(), k


def test_each_piece_is_written_once(hybrid_versions):
    """The ranks' ``.distcp`` payloads hold exactly the global trees'
    bytes: no replica is written twice."""
    hv = hybrid_versions
    total = 0
    for f in os.listdir(hv["port_step"]):
        if f.endswith(".distcp"):
            with np.load(os.path.join(hv["port_step"], f)) as z:
                total += sum(z[k].nbytes for k in z.files)
    assert total == sum(a.nbytes for a in _flat(hv["jax"]).values())


@pytest.fixture(scope="module")
def zero3_versions(worlds, tmp_path_factory):
    """The JAX package's ZeRO-3 state at dp 4 (seeded parameters, random
    moments, grain 4) saved, loaded at dp 2 by both packages, and saved
    again at dp 2 by both."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from paddle_tpu.distributed.checkpoint import CheckpointManager as JM
    from paddle_tpu.distributed.checkpoint import read_state_dict as jread
    from paddle_tpu.distributed.fleet import hybrid_step as J
    cfg_kw = dict(SMALL, pp=1, mp=1, zero_stage=3)
    cfg4 = J.HybridConfig(**cfg_kw, dp=4)
    mesh4 = _jax_mesh((4,), ("dp",))
    fp, _, _ = J.init_zero3_state(J.init_gpt_params(jax.random.key(9), cfg4),
                                  mesh4)
    rng = np.random.RandomState(4)
    sh = NamedSharding(mesh4, P("dp"))

    def rand(x):
        return jax.device_put(jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), sh)
    m = jax.tree_util.tree_map(rand, fp)
    v = jax.tree_util.tree_map(lambda x: jnp.abs(rand(x)), fp)
    base = tmp_path_factory.mktemp("zero3")
    jax_root = str(base / "jax")
    J.save_zero3_state(JM(jax_root), 4, fp, m, v, 4.0, grain=4, wait=True)
    cfg2 = J.HybridConfig(**cfg_kw, dp=2)
    jstate = J.load_zero3_state(JM(jax_root), _jax_mesh((2,), ("dp",)),
                                cfg2)
    J.save_zero3_state(JM(str(base / "jax2")), 5, *jstate[:3], jstate[3],
                       grain=jstate[4], wait=True)
    ranks = worlds[2].run("task_zero3_io", jax_root, str(base / "port"),
                          dict(cfg_kw, dp=2), timeout=TIMEOUT)
    from paddle_tpu_torch.distributed.checkpoint import read_state_dict
    return dict(jax=[_np_tree(jax.tree_util.tree_leaves(t))
                     for t in jstate[:3]], jax_meta=jstate[3:], ranks=ranks,
                jax_root=jax_root,
                jax_read=jread(str(base / "jax2" / "step_00000005")),
                port_read=read_state_dict(str(base / "port" /
                                              "step_00000005")))


def test_the_port_loads_the_jax_packages_zero3_versions_at_another_dp(
        zero3_versions):
    """A dp 4 version of the JAX package, loaded by the port's ranks at
    dp 2, equals the JAX ``load_zero3_state`` at dp 2 (each rank its
    slice), step count and grain included."""
    zv = zero3_versions
    assert zv["jax_meta"] == (4.0, 4)
    for d_i, step_no, grain, trees in zv["ranks"]:
        assert (step_no, grain) == (4.0, 4)
        for got, want in zip(trees, zv["jax"]):
            for a, w in zip(got, want):
                k = w.shape[0] // 2
                assert a.tobytes() == w[d_i * k:(d_i + 1) * k].tobytes()


def test_the_port_writes_the_jax_packages_zero3_versions(zero3_versions):
    jf, pf = _flat(zero3_versions["jax_read"]), \
        _flat(zero3_versions["port_read"])
    assert sorted(jf) == sorted(pf)
    for k, a in jf.items():
        assert (pf[k].shape, pf[k].dtype) == (a.shape, a.dtype), k
        assert pf[k].tobytes() == a.tobytes(), k


# ------------------------------------------------------------- resumes

def test_hybrid_resume_is_bit_exact(worlds, tmp_path):
    """pp 2 x dp 2 on 4 ranks: save at step 2, restore into fresh
    templates, run to step 4; losses and every rank's gathered tree
    bit-equal to 4 uninterrupted steps (the JAX
    ``test_hybrid_train_state_kill_resume_bit_exact``)."""
    cfg_kw = dict(SMALL, pp=2, dp=2, mp=1)
    ids = np.random.RandomState(0).randint(
        0, SMALL["vocab_size"], (SMALL["n_microbatches"], ROWS,
                                 SMALL["seq_len"])).astype(np.int64)
    res = worlds[4].run("task_hybrid_resume", str(tmp_path), cfg_kw, ids,
                        timeout=TIMEOUT)
    for r in res:
        assert r["step_no"] == 2.0
        assert r["restored"] == r["saved"]
        assert r["got"] == r["ref"]
        assert r["have"] == r["want"]
    assert len({r["have"] for r in res}) == 1


def test_zero3_resume_across_dp_is_bit_exact(worlds, tmp_path):
    """Grain 4: one step at dp 4, saved; resumed at dp 2 for one step,
    saved; resumed at dp 4 for one step: params and both moments
    bit-equal to 3 uninterrupted steps at dp 4 (the JAX
    ``test_zero3_elastic_resume_bit_exact``)."""
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_to_numpy
    cfg_kw = dict(SMALL, pp=1, mp=1, zero_stage=3)
    params = hybrid_params_to_numpy(T.init_gpt_params(
        T.HybridConfig(**cfg_kw, dp=4)))
    ids = np.random.RandomState(1).randint(
        0, SMALL["vocab_size"], (SMALL["n_microbatches"], ROWS,
                                 SMALL["seq_len"])).astype(np.int64)
    root = str(tmp_path)
    at4 = dict(cfg_kw, dp=4)
    at2 = dict(cfg_kw, dp=2)
    ref = worlds[4].run("task_zero3_segment", root, at4, params, ids, 0, 3,
                        None, None, timeout=TIMEOUT)[0]
    worlds[4].run("task_zero3_segment", root, at4, params, ids, 0, 1, None,
                  1, timeout=TIMEOUT)
    worlds[2].run("task_zero3_segment", root, at2, params, ids, 1, 1, 1, 2,
                  timeout=TIMEOUT)
    got = worlds[4].run("task_zero3_segment", root, at4, params, ids, 2, 1,
                        2, None, timeout=TIMEOUT)[0]
    assert got[0] == ref[0][2:]
    for name, a, b in zip("pmv", got[1], ref[1]):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes(), name


def test_zero3_hooks_cold_start_equals_init_zero3_state(worlds):
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_to_numpy
    cfg_kw = dict(SMALL, pp=1, mp=1, dp=2, zero_stage=3)
    params = hybrid_params_to_numpy(T.init_gpt_params(
        T.HybridConfig(**cfg_kw)))
    for step, step_no, grain, same in worlds[2].run(
            "task_zero3_hooks_cold", cfg_kw, params, timeout=TIMEOUT):
        assert (step, step_no, grain, same) == (0, 0.0, 2, True)


def test_zero3_hooks_resume_a_jax_dp4_version_at_dp2(worlds, zero3_versions):
    """``restore_fn`` on the JAX package's dp-4 version (step 4, grain
    4): each dp-2 rank's slices equal the JAX ``load_zero3_state`` at
    dp 2, and the loop resumes at step 4."""
    zv = zero3_versions
    cfg_kw = dict(SMALL, pp=1, mp=1, dp=2, zero_stage=3)
    ranks = worlds[2].run("task_zero3_hooks_restore", zv["jax_root"],
                          cfg_kw, timeout=TIMEOUT)
    for d_i, step, step_no, grain, trees in ranks:
        assert (step, step_no, grain) == (4, 4.0, 4)
        for got, want in zip(trees, zv["jax"]):
            for a, w in zip(got, want):
                k = w.shape[0] // 2
                assert a.tobytes() == w[d_i * k:(d_i + 1) * k].tobytes()


def _jax_serial_losses(params, ids, steps):
    """The JAX package's ``serial_train_step`` (jitted) from the same
    parameters on the same batch."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed.fleet import hybrid_step as J
    cfg = J.HybridConfig(pp=1, mp=1, dp=1, **SMALL)
    step = jax.jit(lambda p, m, v, s, i: J.serial_train_step(p, m, v, s, i,
                                                             cfg))
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, tree)
    state, out = (tree, zeros, zeros), []
    for i in range(steps):
        loss, *state = step(*state, jnp.float32(i + 1),
                            jnp.asarray(ids.astype(np.int32)))
        out.append(float(loss))
    return out


def test_zero3_elastic_kill_and_resume_is_bit_exact(worlds, tmp_path):
    """``run_elastic`` over ``zero3_elastic_hooks`` at grain 2: killed in
    step 3 at dp 4 (after the save of step 2), resumed at dp 2 (a 4 -> 2
    reshard) to step 4.  Steps 3-4's losses and the whole params and
    moments equal an uninterrupted dp-2 run's bit for bit; its losses
    are within fp32 tolerance of the JAX ``serial_train_step``."""
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_to_numpy
    cfg_kw = dict(SMALL, pp=1, mp=1, zero_stage=3)
    params = hybrid_params_to_numpy(T.init_gpt_params(
        T.HybridConfig(**cfg_kw, dp=2)))
    ids = np.random.RandomState(5).randint(
        0, SMALL["vocab_size"], (SMALL["n_microbatches"], ROWS,
                                 SMALL["seq_len"])).astype(np.int64)
    at2, at4 = dict(cfg_kw, dp=2), dict(cfg_kw, dp=4)
    ref = worlds[2].run("task_zero3_elastic", str(tmp_path / "ref"), at2,
                        params, ids, 0, None, timeout=TIMEOUT)
    root = str(tmp_path / "killed")
    dead = worlds[4].run("task_zero3_elastic", root, at4, params, ids, 0, 2,
                         timeout=TIMEOUT)
    assert all(d["killed"] and sorted(d["losses"]) == [1, 2] for d in dead)
    got = worlds[2].run("task_zero3_elastic", root, at2, params, ids, 1,
                        None, timeout=TIMEOUT)
    jax_losses = _jax_serial_losses(params, ids, 4)
    for r, g in zip(ref, got):
        assert not g["killed"] and g["steps"] == 4 and g["resumes"] == 1
        assert sorted(g["losses"]) == [3, 4]
        assert [g["losses"][i] for i in (3, 4)] == \
            [r["losses"][i] for i in (3, 4)]
        for a, b in zip(g["whole"], r["whole"]):
            assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
        assert [dead[0]["losses"][i] for i in (1, 2)] == \
            [r["losses"][i] for i in (1, 2)]
        np.testing.assert_allclose([r["losses"][i] for i in range(1, 5)],
                                   jax_losses, rtol=2e-4, atol=2e-5)


def test_restore_into_refuses_a_resize_unless_asked(tmp_path):
    """The JAX ``test_restore_into_requires_explicit_resize``: a trailing
    difference raises without ``resize_trailing``, grows with zeros and
    shrinks with it; any other difference always raises."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"s": {"a": torch.arange(12, dtype=torch.float32)}},
             wait=True)

    def tgt(shape):
        return {"s": {"a": torch.zeros(shape)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore_into(tgt((16,)), step=1)
    grown, _ = mgr.restore_into(tgt((16,)), step=1, resize_trailing=True)
    assert torch.equal(grown["s"]["a"][:12], torch.arange(12.0))
    assert (grown["s"]["a"][12:] == 0).all()
    shrunk, _ = mgr.restore_into(tgt((8,)), step=1, resize_trailing=True)
    assert torch.equal(shrunk["s"]["a"], torch.arange(8.0))
    with pytest.raises(ValueError, match="resize_trailing"):
        mgr.restore_into(tgt((2, 12)), step=1, resize_trailing=True)
    arrays, _ = mgr.restore_into({"s": {"a": np.zeros(12, np.float32)}},
                                 step=1)
    assert torch.equal(arrays["s"]["a"], torch.arange(12.0))


# ------------------------------------------------------ CheckpointManager

def _state(seed=0, n=3):
    rng = np.random.RandomState(seed)
    return {"model": {f"w{i}": torch.from_numpy(
                rng.rand(4, 4).astype(np.float32)) for i in range(n)},
            "meta": {"step": 7 * seed, "note": "hello", "shape": (1, 2, 3)}}


def test_commit_layout_load_and_extras(tmp_path):
    """The JAX ``test_atomic_commit_layout`` and
    ``test_load_round_trip_with_extras``."""
    import json

    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         verify_version)
    from paddle_tpu_torch.distributed.checkpoint import manager
    m = CheckpointManager(str(tmp_path))
    assert m.save(1, _state(3))
    path = m.step_path(1)
    assert os.path.exists(os.path.join(path, "COMPLETE"))
    with open(os.path.join(path, "manifest_0.json")) as f:
        man = json.load(f)
    assert man["schema"] == manager.MANIFEST_SCHEMA
    assert set(man["files"]) == {"0_0.distcp", "0.metadata", "extra_0.pkl"}
    assert verify_version(path) is None
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert m.save(1, _state()) is False
    out = m.load()
    for k, want in _state(3)["model"].items():
        np.testing.assert_array_equal(out["model"][k], want.numpy())
    assert out["meta"] == {"step": 21, "note": "hello", "shape": (1, 2, 3)}
    assert m.last_save["bytes"] == 3 * 64 and m.last_save["step"] == 1


def test_rotation_keeps_the_last_n_and_the_periodic(tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         all_steps)
    from paddle_tpu_torch.observability import metrics
    m = CheckpointManager(str(tmp_path), keep_last=2, keep_period=10)
    for s in range(5, 45, 5):
        m.save(s, _state())
    assert all_steps(str(tmp_path)) == [10, 20, 30, 35, 40]
    assert metrics.get("ckpt.rotated").total() == 3
    CheckpointManager(str(tmp_path), keep_last=1).save(45, _state())
    assert all_steps(str(tmp_path)) == [45]


def test_async_save_owns_its_snapshot(tmp_path):
    """The source is overwritten right after ``save()`` returns; the
    version holds the values it had at the call."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    m = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.full((256, 256), 7.0)
    assert m.save(1, {"w": w})
    w.fill_(0.0)
    m.wait()
    np.testing.assert_array_equal(m.load(1)["w"], 7.0)


def test_a_corrupt_version_is_skipped_and_reported(tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         latest_complete)
    from paddle_tpu_torch.observability import flight_recorder as flight
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.testing import chaos
    m = CheckpointManager(str(tmp_path), keep_last=3)
    m.save(1, _state(1))
    m.save(2, _state(2))
    m.save(3, _state(3))
    data = os.path.join(m.step_path(3), "0_0.distcp")
    chaos.flip_bytes(data, os.path.getsize(data) // 2, count=2)
    chaos.truncate_file(os.path.join(m.step_path(2), "0.metadata"), 10)
    assert latest_complete(str(tmp_path)) == 1
    assert metrics.get("ckpt.skipped_corrupt").value(reason="corrupt") == 2
    events = [e for e in flight.default_recorder().events()
              if e.get("kind") == "ckpt_skip_corrupt"]
    assert [e["step"] for e in events] == [3, 2]
    with pytest.raises(ValueError, match="checksum mismatch"):
        m.load(3)
    with pytest.raises(ValueError, match="size mismatch"):
        m.restore_into(_state(2), step=2)
    np.testing.assert_array_equal(m.load()["model"]["w0"],
                                  _state(1)["model"]["w0"].numpy())


def test_failed_writes_retry_or_never_commit(tmp_path, monkeypatch):
    """One flaky open retries and commits; a write torn mid-file with no
    retries never commits; an async save's failure raises at the next
    ``wait()`` (``IO_RETRIES`` / ``IO_BACKOFF_S``: the JAX flags
    ``ckpt_io_retries`` / ``ckpt_io_backoff_s``)."""
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         latest_complete)
    from paddle_tpu_torch.distributed.checkpoint import manager
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.testing import chaos
    monkeypatch.setattr(manager, "IO_BACKOFF_S", 0.001)
    m = CheckpointManager(str(tmp_path))
    with chaos.fail_open(".distcp", on_calls=[1]) as fault:
        assert m.save(1, _state())
    assert fault.fires == 1 and m.latest_complete() == 1
    assert metrics.get("ckpt.io_retries").total() == 1
    monkeypatch.setattr(manager, "IO_RETRIES", 0)
    with chaos.truncate_writes(".distcp", at_byte=200):
        with pytest.raises(OSError):
            m.save(2, _state(2))
    assert latest_complete(str(tmp_path)) == 1
    assert metrics.get("ckpt.saves").value(result="failed") == 1
    ma = CheckpointManager(str(tmp_path), async_save=True)
    with chaos.fail_open(".metadata"):
        assert ma.save(3, _state())
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            ma.wait()
    ma.save(4, _state(), wait=True)
    assert ma.latest_complete() == 4


def test_preemption_flag_and_signal_handlers(tmp_path):
    """``request_preemption`` sets the flag once (counted); the handler
    ``install_signal_handlers`` puts in place sets it when called, and
    ``uninstall_signal_handlers`` puts the old one back.  No signal is
    sent: the test worker keeps its own handlers."""
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointManager, clear_preemption, preemption_requested,
        request_preemption)
    from paddle_tpu_torch.observability import metrics
    m = CheckpointManager(str(tmp_path))
    assert not m.preempted
    request_preemption(signal.SIGTERM)
    request_preemption(signal.SIGTERM)
    assert preemption_requested() and m.preempted
    assert metrics.get("preempt.signals").total() == 1
    clear_preemption()
    before = signal.getsignal(signal.SIGTERM)
    with m:
        m.install_signal_handlers()
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not before and callable(handler)
        handler(signal.SIGTERM, None)
        assert m.preempted
    assert signal.getsignal(signal.SIGTERM) is before


# ----------------------------------------------------------------- fit

class _Pairs:
    def __init__(self):
        rng = np.random.RandomState(1)
        self.x = rng.rand(32, 4).astype(np.float32)
        self.y = self.x.sum(axis=1, keepdims=True).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _fit_model():
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch import optimizer as toptim
    from paddle_tpu_torch.core import random as trandom
    trandom.seed(11)
    torch.manual_seed(3)
    np.random.seed(5)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Dropout(0.25),
                              torch.nn.Linear(8, 1))
    model = hapi.Model(net)
    model.prepare(optimizer=toptim.Adam(learning_rate=0.05,
                                        parameters=net.named_parameters()),
                  loss=torch.nn.MSELoss())
    return model


def _fit(model, **kw):
    from paddle_tpu_torch.hapi.callbacks import Callback
    losses = []

    class Record(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
    model.fit(_Pairs(), batch_size=8, epochs=2, verbose=0, shuffle=True,
              callbacks=[Record()] + kw.pop("callbacks", []), **kw)
    return losses


def _fit_state(model):
    opt = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in model._optimizer.state_dict().items()}
    return [p.detach().clone() for p in model.network.parameters()], opt


@pytest.mark.parametrize("at", [6, 4], ids=["mid_epoch", "epoch_boundary"])
def test_fit_resumes_bit_exact_after_a_preemption(tmp_path, at):
    """The flag set after step ``at`` (6: mid-epoch 2; 4: the last step of
    epoch 1) makes fit finish the step, commit an emergency version and
    stop; a fresh model resumed from it ends with the parameters, the
    optimizer state and the losses of an uninterrupted fit (shuffle and
    dropout on: numpy's and torch's generators are restored too)."""
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         latest_complete)
    from paddle_tpu_torch.distributed.checkpoint import manager
    from paddle_tpu_torch.hapi.callbacks import Callback
    ref = _fit_model()
    ref_losses = _fit(ref)
    crash = _fit_model()

    class Preempt(Callback):
        def on_train_batch_end(self, step, logs=None):
            if crash._train_steps == at:
                manager.request_preemption(signal.SIGTERM)
    root = str(tmp_path)
    first = _fit(crash, callbacks=[Preempt()],
                 checkpoint=CheckpointManager(root, save_interval=100))
    assert crash.stop_training and latest_complete(root) == at
    resumed = _fit_model()
    rest = _fit(resumed, checkpoint=CheckpointManager(root), resume=True)
    assert first + rest == ref_losses
    (pa, oa), (pb, ob) = _fit_state(ref), _fit_state(resumed)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    assert sorted(oa) == sorted(ob)
    for k in oa:
        if isinstance(oa[k], torch.Tensor):
            assert torch.equal(oa[k], ob[k]), k
        else:
            assert oa[k] == ob[k], k


def test_fit_starts_fresh_on_an_empty_root_and_needs_a_checkpoint(tmp_path):
    """``resume=True`` on an empty root trains as without it, saving every
    step (``save_interval`` 1, the last two kept); ``resume`` without
    ``checkpoint`` raises ``ValueError``."""
    from paddle_tpu_torch.distributed.checkpoint import all_steps
    ref = _fit(_fit_model())
    got = _fit(_fit_model(), checkpoint=str(tmp_path), resume=True)
    assert got == ref
    assert all_steps(str(tmp_path)) == [7, 8]
    with pytest.raises(ValueError, match="requires checkpoint"):
        _fit_model().fit(_Pairs(), batch_size=8, verbose=0, resume=True)


def test_ranks_import_neither_jax_nor_the_jax_package(worlds):
    for w in worlds.values():
        assert w.run("task_modules", timeout=TIMEOUT) == [[]] * w.W


if __name__ == "__main__":
    sys.exit(serve(TASKS))
