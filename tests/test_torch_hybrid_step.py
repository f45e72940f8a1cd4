"""The port's hybrid train step (pp x dp x mp, Megatron SP, ZeRO-1/2, VPP,
remat, context parallelism by ring or Ulysses attention, expert
parallelism) and fused ZeRO-3 step on the CPU, against the JAX package.

The ranks are spawned worlds of 2, 4 and 8 CPU processes over gloo
(``_torch_world.py``); they import the port and torch, never jax.  The
JAX hybrid step compiles for 20-60 s a configuration on the CPU mesh, and
the JAX package holds it to its serial functions in its own slow tests
(``tests/test_hybrid_step.py``); so the ranks are held here to the JAX
package's ``serial_train_step``: one run of it on the tiny GPT (H 64, 4
heads, S 32, V 128, 4 layers, 4 micro-batches of 4 rows, Adam lr 1e-3)
is the reference of every configuration (a second, with 4 experts in
every block, of the expert-parallel one).  Losses within rtol 2e-4 and
atol 2e-5 (the JAX tests' bound); parameters within 2 x lr x steps
(ROADMAP.md reference fact 6: Adam moves a weight whose gradient is
rounding noise by up to lr a step).  Adam's update hardly sees a
gradient's scale, so a sum done twice or a mean taken twice would pass
those bounds: one step's gathered gradients are also held against
``jax.grad`` of the JAX serial loss, at rtol 1e-4 / atol 1e-6.
"""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_world import ROOT, World, serve  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STEPS = 3
LR = 1e-3
BASE = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
            seq_len=32, n_microbatches=4, learning_rate=LR)
B = 4                        # rows of each micro-batch
W_SIZES = (2, 4, 8)
TIMEOUT = 120                # seconds a multi-rank task may take


# ---------------------------------------------------------------- ranks
def task_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def _fleet(pp=1, dp=1, mp=1, cp=1):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                            sharding_degree=1, sep_degree=cp)
    return fleet.init(is_collective=True, strategy=s)


def _hybrid_setup(T, cfg_kw, params, dev):
    """This rank's topology, config, shard of ``params`` (the JAX serial
    tree) and step."""
    from paddle_tpu_torch.models.convert import hybrid_params_from_numpy
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(cfg.pp, cfg.dp, cfg.mp, cfg.cp)
    stacked = T.stack_for_pipeline(
        hybrid_params_from_numpy(params, device=dev), cfg)
    local = T.hybrid_local_params(stacked, cfg, hcg.get_stage_id(),
                                  hcg.get_model_parallel_rank(),
                                  hcg.get_data_parallel_rank())
    return cfg, hcg, local, T.make_hybrid_train_step(hcg, cfg)


def task_hybrid(cfg_kw, params, ids, steps, dev="cpu"):
    """``make_hybrid_train_step`` on this rank's shard of ``params`` (the
    JAX serial tree) on ``dev``: the losses and the gathered serial
    parameters (on the card also the flash launches and plain routes)."""
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_to_numpy
    from paddle_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv)
    for fn in fns:
        fn.launches = 0
    fa.flash_attention_fwd.plain_calls = 0
    cfg, hcg, local, step = _hybrid_setup(T, cfg_kw, params, dev)
    m, v, _ = T.init_zero_state(local, T.hybrid_param_specs(cfg), cfg.dp)
    losses = []
    for i in range(steps):
        loss, local, m, v = step(local, m, v, float(i + 1),
                                 torch.from_numpy(ids))
        losses.append(float(loss))
    full = T.gather_hybrid_params(local, cfg, hcg)
    out = (losses, hybrid_params_to_numpy(T.unstack_for_pipeline(full, cfg)))
    if dev == "cpu":
        return out
    return out + ([fn.launches for fn in fns],
                  fa.flash_attention_fwd.plain_calls)


def task_grads(cfg_kw, params, ids):
    """``step.value_and_grad`` on this rank's shard: the loss and the
    gathered serial gradient tree."""
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import hybrid_params_to_numpy
    cfg, hcg, local, step = _hybrid_setup(T, cfg_kw, params, "cpu")
    loss, grads = step.value_and_grad(local, torch.from_numpy(ids))
    full = T.gather_hybrid_params(grads, cfg, hcg)
    return float(loss), hybrid_params_to_numpy(
        T.unstack_for_pipeline(full, cfg))


def task_serial(cfg_kw, params, ids, steps):
    """The port's ``serial_forward`` on the first micro-batch and
    ``steps`` of ``serial_train_step`` (in a rank: one thread)."""
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import (hybrid_params_from_numpy,
                                                 hybrid_params_to_numpy)
    cfg = T.HybridConfig(**cfg_kw)
    params = hybrid_params_from_numpy(params)
    assert hybrid_params_to_numpy(params)["head"].tobytes() == \
        params["head"].numpy().tobytes()
    ids = torch.from_numpy(ids)
    first = float(T.serial_forward(params, ids[0], cfg))
    zeros = T.tree_map(torch.zeros_like, params)
    state, losses = (params, zeros, zeros), []
    for i in range(steps):
        loss, *state = T.serial_train_step(*state, float(i + 1), ids, cfg)
        losses.append(float(loss))
    return first, losses, hybrid_params_to_numpy(state[0])


def task_zero3(cfg_kw, params, ids, steps, grain):
    """``make_zero3_train_step`` over every rank: the losses, and the
    serial parameters from the ranks' gathered slices."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    from paddle_tpu_torch.models.convert import (hybrid_params_from_numpy,
                                                 hybrid_params_to_numpy)
    cfg = T.HybridConfig(**cfg_kw)
    hcg = _fleet(dp=cfg.dp)
    fp, m, v = T.init_zero3_state(hybrid_params_from_numpy(params), cfg.dp,
                                  hcg.get_data_parallel_rank())
    step = T.make_zero3_train_step(hcg, cfg, grain=grain)
    losses = []
    for i in range(steps):
        loss, fp, m, v = step(fp, m, v, float(i + 1), torch.from_numpy(ids))
        losses.append(float(loss))
    g = hcg.get_data_parallel_group()
    full = T.tree_map(lambda t: coll.all_gather_concat(t, 0, g), fp)
    return (losses, hybrid_params_to_numpy(T.zero3_unflatten(full, cfg)),
            step.buckets)


TASKS = {k: v for k, v in globals().items() if k.startswith("task_")}


# ----------------------------------------------------------- controller
@pytest.fixture(scope="module")
def worlds():
    ws = {W: World(W, __file__) for W in W_SIZES}
    yield ws
    for w in ws.values():
        w.close()


def _jax_reference(**extra):
    """The JAX package's serial GPT: its parameters, the batches,
    ``STEPS`` Adam steps of ``serial_train_step`` (losses, parameters),
    and the first step's gradients: ``jax.grad`` of the serial loss
    inside ``serial_train_step``, read back from Adam's first moment
    ``m = (1 - beta1) g`` (no second compile)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed.fleet import hybrid_step as J
    cfg = J.HybridConfig(pp=1, mp=1, dp=1, **BASE, **extra)
    params = J.init_gpt_params(jax.random.key(42), cfg)
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (cfg.n_microbatches, B, cfg.seq_len)) \
        .astype(np.int32)
    step = jax.jit(lambda p, m, v, s, i: J.serial_train_step(p, m, v, s, i,
                                                             cfg))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    state = (params, zeros, zeros)
    losses = []
    for i in range(STEPS):
        loss, *state = step(*state, jnp.float32(i + 1), jnp.asarray(ids))
        losses.append(float(loss))
        if i == 0:
            grads = jax.tree_util.tree_map(
                lambda m: np.asarray(m, np.float64) / (1 - cfg.beta1),
                state[1])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=to_np(params), ids=ids.astype(np.int64),
                losses=losses, after=to_np(state[0]), cfg=cfg, grads=grads)


@pytest.fixture(scope="module")
def reference(worlds):
    """The dense model's reference, compiled while the worlds' ranks
    start."""
    return _jax_reference()


@pytest.fixture(scope="module")
def moe_reference(worlds):
    """The reference with a 4-expert switch MoE in every block."""
    return _jax_reference(moe_num_experts=4)


def _assert_matches(losses, params, ref, bound=2 * LR * STEPS):
    np.testing.assert_allclose(losses, ref["losses"], rtol=2e-4, atol=2e-5)
    want = ref["after"]
    for k in ("wte", "wpe", "lnf_g", "lnf_b", "head"):
        np.testing.assert_allclose(params[k], want[k], atol=bound, rtol=0,
                                   err_msg=k)
    for k, w in want["blocks"].items():
        np.testing.assert_allclose(params["blocks"][k], w, atol=bound,
                                   rtol=0, err_msg=k)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _assert_replicas_equal(trees):
    """Every rank's gathered tree holds the same bits: the leaves no
    axis splits are each rank's own copy, and a missing replica sum leaves
    a stage's unused copy behind (within the 2 lr-steps bound)."""
    flat = [np.concatenate([a.ravel() for a in _leaves(p)]) for p in trees]
    for other in flat[1:]:
        assert other.tobytes() == flat[0].tobytes()


def test_schedule_table_and_bubble_fraction_equal_the_jax_functions():
    from paddle_tpu.distributed.fleet import hybrid_step as J
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    for pp in (1, 2, 3, 4, 8):
        for vpp in (1, 2, 3, 4):
            for M in (pp, 2 * pp, 4 * pp):
                assert T.schedule_table(pp, vpp, M) == \
                    J.schedule_table(pp, vpp, M)
                assert T.bubble_fraction(pp, vpp, M) == \
                    J.bubble_fraction(pp, vpp, M)
    assert T.bubble_fraction(2, 2, 4) == 0.125


def test_serial_functions_equal_the_jax_package(worlds, reference):
    """``serial_forward`` and ``STEPS`` of ``serial_train_step`` on the
    converted parameters (one process, a rank of the 2-world)."""
    import jax.numpy as jnp
    from paddle_tpu.distributed.fleet import hybrid_step as J
    want = float(J.serial_forward(reference["params"],
                                  jnp.asarray(reference["ids"][0]),
                                  reference["cfg"]))
    first, losses, params = worlds[2].run(
        "task_serial", dict(BASE, pp=1, mp=1, dp=1), reference["params"],
        reference["ids"], STEPS, timeout=TIMEOUT)[0]
    np.testing.assert_allclose(first, want, rtol=1e-5)
    _assert_matches(losses, params, reference)


HYBRID_CASES = {
    "pp2_dp2_mp2_sp_zero1": (8, dict(pp=2, dp=2, mp=2)),
    "pp2_vpp2": (2, dict(pp=2, dp=1, mp=1, vpp=2)),
    "pp4": (4, dict(pp=4, dp=1, mp=1)),
    "mp2_no_sp": (2, dict(pp=1, dp=1, mp=2, sequence_parallel=False)),
    "dp2_zero2": (2, dict(pp=1, dp=2, mp=1, zero_stage=2)),
    "pp2_mp2_sp_no_remat": (4, dict(pp=2, dp=1, mp=2, remat=False)),
    # the JAX package's test_hybrid_context_parallel and
    # test_hybrid_moe_expert_parallel
    "pp2_dp2_cp2_ring": (8, dict(pp=2, dp=2, mp=1, cp=2,
                                 sequence_parallel=False)),
    "pp2_dp2_cp2_ulysses": (8, dict(pp=2, dp=2, mp=1, cp=2,
                                    cp_attention="ulysses",
                                    sequence_parallel=False)),
    "pp2_dp2_mp2_sp_moe4_zero2": (8, dict(pp=2, dp=2, mp=2,
                                          moe_num_experts=4, zero_stage=2)),
}


def _reference_of(request, kw):
    return request.getfixturevalue(
        "moe_reference" if kw.get("moe_num_experts") else "reference")


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_hybrid_step_matches_the_jax_serial_step(worlds, request, case):
    W, kw = HYBRID_CASES[case]
    ref = _reference_of(request, kw)
    res = worlds[W].run("task_hybrid", dict(BASE, **kw), ref["params"],
                        ref["ids"], STEPS, timeout=TIMEOUT)
    for losses, params in res:
        _assert_matches(losses, params, ref)
    _assert_replicas_equal([p for _, p in res])


@pytest.mark.parametrize("case", ["pp2_dp2_cp2_ring", "pp2_dp2_cp2_ulysses",
                                  "pp2_dp2_mp2_sp_moe4_zero2",
                                  "pp2_dp2_mp2_sp_zero1"])
def test_one_step_gradients_equal_jax_grad(worlds, request, case):
    """Every rank's gathered gradient tree of one step against
    ``jax.grad`` of the JAX serial loss: a sum over cp, dp, mp or pp
    missing or done twice shows here, where Adam's update would hide
    it."""
    W, kw = HYBRID_CASES[case]
    ref = _reference_of(request, kw)
    res = worlds[W].run("task_grads", dict(BASE, **kw), ref["params"],
                        ref["ids"], timeout=TIMEOUT)
    want = ref["grads"]
    for loss, grads in res:
        np.testing.assert_allclose(loss, ref["losses"][0], rtol=2e-4,
                                   atol=2e-5)
        for k in ("wte", "wpe", "lnf_g", "lnf_b", "head"):
            np.testing.assert_allclose(grads[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert sorted(grads["blocks"]) == sorted(want["blocks"])
        for k, w in want["blocks"].items():
            np.testing.assert_allclose(grads["blocks"][k], w, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dp", [2, 4])
def test_zero3_step_matches_the_jax_serial_step(worlds, reference, dp):
    res = worlds[dp].run("task_zero3",
                         dict(BASE, pp=1, mp=1, dp=dp, zero_stage=3),
                         reference["params"], reference["ids"], STEPS, 0,
                         timeout=TIMEOUT)
    for losses, params, buckets in res:
        _assert_matches(losses, params, reference)
        assert buckets == [tuple(range(17))]     # 0.9 MiB: one bucket


def test_zero3_grain_is_bit_equal_across_dp(worlds, reference):
    """grain 2: every rank differentiates both row groups against the
    whole parameters, so dp 2 and dp 4 give the same bits."""
    got = {}
    for dp in (2, 4):
        res = worlds[dp].run("task_zero3",
                             dict(BASE, pp=1, mp=1, dp=dp, zero_stage=3),
                             reference["params"], reference["ids"], STEPS,
                             2, timeout=TIMEOUT)
        got[dp] = res[0]
        for losses, params, _ in res:
            _assert_matches(losses, params, reference)
    (l2, p2, _), (l4, p4, _) = got[2], got[4]
    assert l2 == l4
    for k in ("wte", "wpe", "lnf_g", "lnf_b", "head"):
        assert p2[k].tobytes() == p4[k].tobytes(), k
    for k in p2["blocks"]:
        assert p2["blocks"][k].tobytes() == p4["blocks"][k].tobytes(), k


def test_ranks_import_neither_jax_nor_the_jax_package(worlds):
    for w in worlds.values():
        assert w.run("task_modules", timeout=TIMEOUT) == [[]] * w.W


def test_the_slices_to_come_refuse():
    """cp and experts refuse what the JAX config and ZeRO-3 step refuse;
    the checkpoints take the JAX functions' arguments."""
    from paddle_tpu.distributed.fleet import hybrid_step as J
    from paddle_tpu_torch.distributed.fleet import hybrid_step as T
    for kw in (dict(cp=2, mp=2, sequence_parallel=False),
               dict(cp=2, mp=1),                     # SP on by default
               dict(cp=2, mp=1, sequence_parallel=False, seq_len=33),
               dict(cp=2, mp=1, sequence_parallel=False,
                    moe_num_experts=4),
               dict(cp=3, mp=1, sequence_parallel=False, seq_len=33,
                    cp_attention="ulysses"),
               dict(moe_num_experts=3),
               dict(moe_num_experts=4, sequence_parallel=False)):
        with pytest.raises(AssertionError):
            J.HybridConfig(**kw)
        with pytest.raises(AssertionError):
            T.HybridConfig(**kw)
    T.HybridConfig(cp=2, mp=1, sequence_parallel=False)
    T.HybridConfig(moe_num_experts=4)
    for kw in (dict(cp=2, sequence_parallel=False),
               dict(moe_num_experts=2)):
        cfg = T.HybridConfig(pp=1, mp=1, dp=2, zero_stage=3, **kw)
        with pytest.raises(AssertionError):
            T.make_zero3_train_step(2, cfg)
    # the checkpoints take the JAX signatures: the mesh's place holds the
    # topology, and the saves add the keyword-only cfg and hcg
    for name in ("save_hybrid_state", "load_hybrid_state",
                 "save_zero3_state", "load_zero3_state"):
        want = [(p.name, p.kind, p.default) for p in
                inspect.signature(getattr(J, name)).parameters.values()]
        got = [(p.name, p.kind, p.default) for p in
               inspect.signature(getattr(T, name)).parameters.values()]
        if name.startswith("load"):
            assert want[1][0] == "mesh"
            want[1] = ("hcg",) + want[1][1:]
        else:
            want += [("cfg", inspect.Parameter.KEYWORD_ONLY,
                      inspect.Parameter.empty),
                     ("hcg", inspect.Parameter.KEYWORD_ONLY, None)]
        assert got == want, name


if __name__ == "__main__":
    sys.exit(serve(TASKS))
