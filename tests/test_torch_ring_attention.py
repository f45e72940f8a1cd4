"""The port's ring and Ulysses attention
(``paddle_tpu_torch/incubate/nn/functional/ring_attention.py``) on the
CPU, against the JAX package.

The ranks are forked worlds of 2 and 4 CPU processes over gloo
(``_torch_world.py``), each rank of ``fleet``'s sep group holding its
slice of the sequence; they import the port and torch, never jax.  The
yardstick of a ring rank is the JAX package's fast single-device member
program, ``ring_attention_chunked(q_slice, k, v, n_chunks=n,
q_off=rank * C)``, which runs the same hop program on the Pallas flash
kernels in interpret mode (head dim 64, inside their envelope): the
rank's output and dq are its member's, and its chunk's dk / dv the sum of
every member's dk / dv at that chunk.  Shapes the kernels do not take
(head dim 16) and Ulysses are held against the JAX package's dense
attention.  Tolerances, float32: atol 1e-5 on outputs, 1e-4 on
gradients.
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
TIMEOUT = 120
B, H, S = 1, 4, 32
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


# ---------------------------------------------------------------- ranks
def task_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "paddle_tpu"))


def _sep_fleet():
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(dp_degree=1, mp_degree=1, pp_degree=1,
                            sharding_degree=1,
                            sep_degree=torch.distributed.get_world_size())
    return fleet.init(is_collective=True, strategy=s)


def task_local(kind, q, k, v, g, causal, scale):
    """``ring_attention_local`` or ``ulysses_attention_local`` on this
    rank's slice, over fleet's sep group (the default): the output, and
    the gradients of ``sum(out * g_slice)`` at its slices of q, k, v."""
    from paddle_tpu_torch.incubate.nn import functional as tf
    hcg = _sep_fleet()
    n, r = hcg.get_sep_parallel_world_size(), hcg.get_sep_parallel_rank()
    C = q.shape[2] // n
    sl = slice(r * C, (r + 1) * C)
    qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(x[:, :, sl]))
                  .requires_grad_() for x in (q, k, v))
    fn = tf.ring_attention_local if kind == "ring" else \
        tf.ulysses_attention_local
    out = fn(qs, ks, vs, causal=causal, scale=scale)
    (out * torch.from_numpy(np.ascontiguousarray(g[:, :, sl]))).sum() \
        .backward()
    return tuple(t.detach().numpy() for t in (out, qs.grad, ks.grad,
                                              vs.grad))


def task_whole(kind, q, k, v, g, causal):
    """The whole-tensor wrapper: the output and the gradients of
    ``sum(out * g)`` at the whole q, k, v, on every rank."""
    from paddle_tpu_torch.incubate.nn import functional as tf
    _sep_fleet()
    x = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    fn = tf.ring_attention if kind == "ring" else tf.ulysses_attention
    out = fn(*x, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    return (out.detach().numpy(),) + tuple(t.grad.numpy() for t in x)


def task_ulysses_refuses(H_, nkv):
    from paddle_tpu_torch.incubate.nn import functional as tf
    _sep_fleet()
    x = torch.zeros((1, H_, 8, 16))
    try:
        tf.ulysses_attention_local(x, torch.zeros((1, nkv, 8, 16)),
                                   torch.zeros((1, nkv, 8, 16)))
    except ValueError as e:
        return str(e)
    return None


TASKS = {k: v for k, v in globals().items() if k.startswith("task_")}


# ----------------------------------------------------------- controller
@pytest.fixture(scope="module")
def worlds():
    ws = {W: World(W, __file__) for W in W_SIZES}
    yield ws
    for w in ws.values():
        w.close()


def _inputs(nkv, D=64, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, S, D).astype(np.float32)
    k, v = (rng.randn(B, nkv, S, D).astype(np.float32) for _ in range(2))
    return q, k, v, rng.randn(B, H, S, D).astype(np.float32)


@pytest.fixture(scope="module")
def jax_members():
    """``members(n, causal, nkv, scale)``: every member's output and (dq,
    dk, dv) under the JAX ``ring_attention_chunked`` (Pallas, interpret
    mode) for the cotangent g's slice; one jitted program a
    configuration, kept for the module."""
    cache = {}

    def members(*key):
        if key not in cache:
            cache[key] = _jax_members(*key)
        return cache[key]
    return members


def _jax_members(n, causal, nkv, scale):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.incubate.nn.functional.ring_attention import \
        ring_attention_chunked
    C = S // n

    def members(q, k, v, g):
        out = []
        for r in range(n):
            def f(qq, kk, vv, r=r):
                return ring_attention_chunked(qq, kk, vv, n_chunks=n,
                                              causal=causal, scale=scale,
                                              q_off=r * C)
            o, vjp = jax.vjp(f, q[:, :, r * C:(r + 1) * C], k, v)
            out.append((o,) + vjp(g[:, :, r * C:(r + 1) * C]))
        return out
    q, k, v, g = _inputs(nkv)
    res = jax.jit(members)(*(jnp.asarray(x) for x in (q, k, v, g)))
    return [tuple(np.asarray(t) for t in m) for m in res]


def _jax_dense(q, k, v, g, causal, scale=None):
    """The JAX package's dense attention (Ulysses' fallback,
    ``_dense_attention``): output and gradients of ``sum(out * g)``."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.incubate.nn.functional.ring_attention import \
        _dense_attention
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    out, vjp = jax.vjp(lambda a, b, c: _dense_attention(a, b, c, causal, sc),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out),) + tuple(np.asarray(t)
                                      for t in vjp(jnp.asarray(g)))


# (ranks, causal, kv heads, scale): GQA at kv heads 2; a custom scale
RING_CASES = [(2, False, 4, None), (2, True, 2, 0.1), (4, False, 2, None),
              (4, True, 4, None)]


@pytest.mark.parametrize("n,causal,nkv,scale", RING_CASES)
def test_ring_ranks_match_the_jax_member_program(worlds, jax_members, n,
                                                 causal, nkv, scale):
    q, k, v, g = _inputs(nkv)
    res = worlds[n].run("task_local", "ring", q, k, v, g, causal, scale,
                        timeout=TIMEOUT)
    want = jax_members(n, causal, nkv, scale)
    C = S // n
    dk_all = sum(m[2] for m in want)
    dv_all = sum(m[3] for m in want)
    for r, (out, dq, dk, dv) in enumerate(res):
        sl = slice(r * C, (r + 1) * C)
        np.testing.assert_allclose(out, want[r][0], atol=OUT_TOL, rtol=0)
        np.testing.assert_allclose(dq, want[r][1], atol=GRAD_TOL, rtol=0)
        np.testing.assert_allclose(dk, dk_all[:, :, sl], atol=GRAD_TOL,
                                   rtol=0)
        np.testing.assert_allclose(dv, dv_all[:, :, sl], atol=GRAD_TOL,
                                   rtol=0)


@pytest.mark.parametrize("n,causal,nkv,scale", RING_CASES)
def test_chunked_member_matches_jax(jax_members, n, causal, nkv, scale):
    """``ring_attention_chunked`` in this process, each member against
    the JAX member program (its dk / dv over the whole context)."""
    from paddle_tpu_torch.incubate.nn import functional as tf
    q, k, v, g = _inputs(nkv)
    want = jax_members(n, causal, nkv, scale)
    C = S // n
    for r in range(n):
        sl = slice(r * C, (r + 1) * C)
        x = [torch.from_numpy(np.ascontiguousarray(t)).requires_grad_()
             for t in (q[:, :, sl], k, v)]
        out = tf.ring_attention_chunked(*x, n_chunks=n, causal=causal,
                                        scale=scale, q_off=r * C)
        (out * torch.from_numpy(np.ascontiguousarray(g[:, :, sl]))).sum() \
            .backward()
        np.testing.assert_allclose(out.detach().numpy(), want[r][0],
                                   atol=OUT_TOL, rtol=0)
        for t, w in zip(x, want[r][1:]):
            np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_TOL,
                                       rtol=0)


def test_chunked_misaligned_member_takes_the_exact_path():
    """A member whose offset is not a whole chunk: the JAX module's
    exact online-softmax path (``_chunked_jnp``) in both packages."""
    import jax.numpy as jnp
    from paddle_tpu.incubate.nn.functional.ring_attention import \
        ring_attention_chunked as jax_chunked
    from paddle_tpu_torch.incubate.nn import functional as tf
    q, k, v, _ = _inputs(2, D=16)
    qs = q[:, :, 5:13]
    want = np.asarray(jax_chunked(jnp.asarray(qs), jnp.asarray(k),
                                  jnp.asarray(v), n_chunks=4, causal=True,
                                  q_off=5))
    got = tf.ring_attention_chunked(torch.from_numpy(qs.copy()),
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    n_chunks=4, causal=True, q_off=5)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_whole_tensor_wrappers_at_head_dim_16(worlds, kind):
    """``ring_attention`` / ``ulysses_attention`` over whole tensors at
    head dim 16 (no kernel takes it: the hops' plain versions), 4 ranks,
    causal, GQA: every rank's output and whole gradients against the JAX
    dense attention."""
    q, k, v, g = _inputs(4 if kind == "ulysses" else 2, D=16, seed=1)
    want = _jax_dense(q, k, v, g, True)
    for got in worlds[4].run("task_whole", kind, q, k, v, g, True,
                             timeout=TIMEOUT):
        np.testing.assert_allclose(got[0], want[0], atol=OUT_TOL, rtol=0)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_ranks_match_jax_dense_attention(worlds, causal):
    """Ulysses at 2 ranks, head dim 64, GQA (kv heads 2), a custom scale
    when causal: each rank's output and gradients against its slice of
    the JAX dense attention's (dk / dv: the whole sequence's gradient,
    sliced)."""
    scale = 0.2 if causal else None
    q, k, v, g = _inputs(2)
    want = _jax_dense(q, k, v, g, causal, scale)
    C = S // 2
    for r, got in enumerate(worlds[2].run("task_local", "ulysses", q, k, v,
                                          g, causal, scale,
                                          timeout=TIMEOUT)):
        sl = slice(r * C, (r + 1) * C)
        np.testing.assert_allclose(got[0], want[0][:, :, sl], atol=OUT_TOL,
                                   rtol=0)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b[:, :, sl], atol=GRAD_TOL,
                                       rtol=0)


def test_ulysses_refuses_heads_that_do_not_divide(worlds):
    """The JAX message: heads or kv heads not divisible by the group
    size raise ValueError (2 query heads, then 2 kv heads, on 4 ranks)."""
    for H_, nkv in ((2, 2), (4, 2)):
        for msg in worlds[4].run("task_ulysses_refuses", H_, nkv,
                                 timeout=TIMEOUT):
            assert msg is not None and "must be divisible by the group " \
                "size (4); use ring_attention instead" in msg, msg


def test_ranks_import_neither_jax_nor_the_jax_package(worlds):
    for w in worlds.values():
        assert w.run("task_modules", timeout=TIMEOUT) == [[]] * w.W


if __name__ == "__main__":
    sys.exit(serve(TASKS))
