"""The port's prefix cache against the JAX package's, on the CPU.

The index (`paddle_tpu_torch/inference/prefix_cache.py` against
`paddle_tpu/inference/prefix_cache.py`): one seeded sequence of lookups,
registrations and evictions drives both, over refcount arrays kept the
same way; their chain hashes, blocks, children, evictions, epochs,
reclaimable counts and exports must be equal at every step.

The engines: the port's `ServingEngine` and the JAX one, both with the
prefix cache on, serve the same mixes on `gpt3_tiny` with the same weights
(`models/convert.py`), whole-prompt and in 16-token chunks: a shared-prefix
mix, the block-aligned prompt that is copied on write, and a pool small
enough that admissions evict index entries.  Greedy and seeded sampled
streams and `stats()["prefix_cache"]` must be equal, and every drained
engine reads `free_blocks == num_blocks`.  The JAX engine runs with its
paged Pallas views off (`FLAGS_serving_pallas_prefill`,
`FLAGS_serving_pallas_verify`: their interpret strategy calls `pl.load`,
which this jax release lacks; the dense views are the same math).  The
engine tests run with the overlapped tick loop off and on, the same on
both engines (`FLAGS_serving_overlap`, the port's `overlap`), so both see
the same boundaries and their `stats()["steps"]` and `["ticks"]` are
equal too; with overlap on, ticks must have been chained.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu_torch.inference import prefix_cache as tpc
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny

ENGINE = dict(max_batch=2, max_context=64, block_size=16, steps_per_tick=4)
JAX_FLAGS = dict(serving_pallas_prefill=False, serving_pallas_verify=False)


# ------------------------------------------------------------------ index

class _Pool:
    """Block refcounts the way the engine keeps them, for one cache."""

    def __init__(self, n):
        self.rc = np.zeros((n + 1,), np.int64)
        self.next = 1

    def alloc(self):
        blk, self.next = self.next, self.next + 1
        self.rc[blk] = 1
        return blk

    def ref(self, blk):
        self.rc[blk] += 1

    def release(self, blk):
        self.rc[blk] -= 1
        return bool(self.rc[blk] <= 0)


def _state(cache):
    return [(h, e.block, e.parent, e.children)
            for h, e in cache._entries.items()]


def test_index_matches_the_jax_index_op_for_op():
    """Prompts from three families sharing prefixes of 1-3 blocks, some
    exactly block-aligned; each admitted prompt is looked up, its missing
    full blocks allocated and registered, its table references dropped
    later; evictions of 1-4 blocks with the engine's freeable test in
    between."""
    bs = 4
    rng = np.random.RandomState(0)
    roots = [rng.randint(1, 50, (12,)).tolist() for _ in range(3)]
    caches = (jpc.PrefixCache(bs), tpc.PrefixCache(bs))
    pools = (_Pool(400), _Pool(400))
    held = []                 # (blocks of a table, one list per side)
    for step in range(120):
        op = rng.randint(4)
        if op < 2 or not held:
            root = roots[rng.randint(3)]
            n = rng.randint(1, 13)
            prompt = root[:n] + rng.randint(1, 50,
                                            (rng.randint(0, 9),)).tolist()
            sides = []
            for cache, pool in zip(caches, pools):
                m = cache.lookup(prompt)
                blocks = list(m.blocks)
                for b in blocks:
                    pool.ref(b)
                while len(blocks) < len(prompt) // bs:
                    blocks.append(pool.alloc())
                added = cache.register(prompt, blocks, pool.ref, match=m)
                sides.append((m.blocks, m.hashes, blocks, added))
            assert sides[0] == sides[1]
            held.append(tuple(s[2] for s in sides))
        elif op == 2:
            for blocks, pool in zip(held.pop(rng.randint(len(held))),
                                    pools):
                for b in blocks:
                    pool.release(b)
        else:
            want = rng.randint(1, 5)
            freed = [c.evict(want, p.release, lambda b, p=p: p.rc[b] == 1)
                     for c, p in zip(caches, pools)]
            assert freed[0] == freed[1]
        j, t = caches
        assert _state(j) == _state(t)
        assert (j.epoch, j.evictions, len(j)) == (t.epoch, t.evictions,
                                                  len(t))
        assert j.reclaimable(pools[0].rc) == t.reclaimable(pools[1].rc)
        assert j.resident_blocks() == t.resident_blocks()
    assert caches[0].evictions > 0 and caches[0].epoch > 0
    assert caches[0].export_state() == caches[1].export_state()
    # the chain is blake2b over int64 token bytes, digest 16, byte-equal
    assert tpc._chain(b"", [1, 2, 3]) == jpc._chain(b"", [1, 2, 3])


def test_import_rebuilds_the_exported_index():
    bs = 4
    src = tpc.PrefixCache(bs)
    pool = _Pool(50)
    for prompt in ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 7, 7, 7, 7]):
        m = src.lookup(prompt)
        blocks = list(m.blocks)
        while len(blocks) < len(prompt) // bs:
            blocks.append(pool.alloc())
        src.register(prompt, blocks, pool.ref, match=m)
    state = src.export_state()
    want = jpc.PrefixCache(bs)
    got = tpc.PrefixCache(bs)
    moves = ([], [])
    new = (_Pool(50), _Pool(50))
    assert want.import_state(state, new[0].alloc,
                             lambda o, n: moves[0].append((o, n))) == 3
    assert got.import_state(state, new[1].alloc,
                            lambda o, n: moves[1].append((o, n))) == 3
    assert moves[0] == moves[1] and _state(want) == _state(got)
    assert [len(x.blocks) for x in (got.lookup([1, 2, 3, 4, 5, 6, 7, 8]),
                                    got.lookup([1, 2, 3, 4, 7, 7, 7, 7]))] \
        == [2, 2]


# ----------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    return jm, tm


def _mix(name):
    """(requests, num_blocks).  ``shared``: five requests on one 32-token
    prompt (two full blocks) with suffixes, two of them sampled.  ``cow``:
    the 32-token prompt alone, three times (reuse is capped at 31 tokens,
    so the second block is copied on write), beside a suffixed one.
    ``evict``: two 32-token prompts in turns through a pool of 5 blocks,
    so admissions reclaim index-only blocks."""
    rng = np.random.RandomState(3)
    a = rng.randint(1, 1024, (32,)).tolist()
    b = rng.randint(1, 1024, (32,)).tolist()

    def sampled(i):
        return dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95,
                    seed=70 + i)
    if name == "shared":
        reqs = [dict(prompt_ids=a + rng.randint(1, 1024, (n,)).tolist(),
                     max_new_tokens=5 + i, **(sampled(i) if i % 2 else {}))
                for i, n in enumerate((5, 11, 16, 3, 20))]
        return reqs, None
    if name == "cow":
        reqs = [dict(prompt_ids=a, max_new_tokens=6),
                dict(prompt_ids=a + [7, 8, 9], max_new_tokens=5),
                dict(prompt_ids=a, max_new_tokens=7, **sampled(1)),
                dict(prompt_ids=a, max_new_tokens=4)]
        return reqs, None
    reqs = [dict(prompt_ids=base + rng.randint(1, 1024, (3 + 5 * i,))
                 .tolist(), max_new_tokens=5 + i,
                 **(sampled(i) if i == 3 else {}))
            for i, base in enumerate((a, b, a, b, a))]
    return reqs, 5


def _serve(engine_cls, req_cls, model, mix, chunk, nb, overlap, **kw):
    if engine_cls is ServingEngine:
        kw["overlap"] = overlap
    eng = engine_cls(model, prefill_chunk=chunk, num_blocks=nb,
                     **{**ENGINE, **kw})
    reqs = [eng.add_request(req_cls(**m)) for m in mix]
    eng.run()
    st = eng.stats()
    assert st["free_blocks"] == eng.num_blocks and st["reserved"] == 0
    assert all(r.done for r in reqs)
    return [list(r.output_ids) for r in reqs], st


@pytest.fixture(scope="module")
def misses():
    """The port's streams of each mix and chunk with the prefix cache off,
    served once: streams depend on neither the overlap nor the tick size
    (only the stats do), so both overlap cases compare with one run."""
    return {}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("name", ["shared", "cow", "evict"])
def test_engine_matches_the_jax_engine(models, monkeypatch, misses, name,
                                       chunk, overlap):
    jm, tm = models
    mix, nb = _mix(name)
    with flag_guard(serving_overlap=overlap, **JAX_FLAGS):
        want, jst = _serve(JaxEngine, JaxRequest, jm, mix, chunk, nb,
                           overlap, prefix_cache=True)
    copies = []
    cow = ServingEngine._cow
    monkeypatch.setattr(ServingEngine, "_cow", lambda self, s, d: (
        copies.append((s, d)), cow(self, s, d)))
    got, st = _serve(ServingEngine, Request, tm, mix, chunk, nb, overlap,
                     device="cpu")
    assert got == want
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert (st["steps"], st["ticks"], st["prefill_chunks"]) == \
        (jst["steps"], jst["ticks"], jst["prefill_chunks"])
    assert (st["overlapped_ticks"] > 0) == overlap
    pc = st["prefix_cache"]
    assert pc["hits"] > 0 and pc["blocks_shared"] > 0
    assert bool(copies) == (name == "cow")
    assert (pc["evictions"] > 0) == (name == "evict")
    # a hit's greedy stream is the miss's
    if (name, chunk) not in misses:
        miss, st_off = _serve(ServingEngine, Request, tm, mix, chunk, nb,
                              overlap, device="cpu", prefix_cache=False)
        assert "prefix_cache" not in st_off
        misses[name, chunk] = miss
    miss = misses[name, chunk]
    greedy = [i for i, m in enumerate(mix) if not m.get("do_sample")]
    assert [got[i] for i in greedy] == [miss[i] for i in greedy]


def test_shared_blocks_outlive_their_holders(models):
    """Refcounts: a block shared by two running requests and the index
    stays allocated until its last holder lets go; after the drain every
    block is free or held by the index alone (reclaimable)."""
    _, tm = models
    a = list(range(1, 33))
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    r1 = eng.add_request(Request(a + [40, 41], max_new_tokens=6))
    r2 = eng.add_request(Request(a + [50], max_new_tokens=9))
    eng.step()
    shared = [int(b) for b in eng.tables[r1.slot, :2]]
    assert list(eng.tables[r2.slot, :2]) == shared
    # two tables and one index entry each
    assert [int(eng.block_rc[b]) for b in shared] == [3, 3]
    eng.run()
    assert [int(eng.block_rc[b]) for b in shared] == [1, 1]
    st = eng.stats()
    assert st["prefix_cache"]["reclaimable_blocks"] == 2
    assert st["free_blocks"] == eng.num_blocks
    assert len(eng.free_blocks) == eng.num_blocks - 2


class _Boom(Exception):
    pass


@pytest.mark.parametrize("where", ["_forward_prompt", "_cow"])
def test_failed_admission_returns_every_reference(models, monkeypatch,
                                                  where):
    """A hit whose copy on write or suffix prefill raises: the error
    reaches the caller, the request leaves the queue, and its slot, its
    growth reservation and every block reference it took (the pinned
    chain, the copy's source, the fresh blocks) come back; the engine
    then serves the next request."""
    _, tm = models
    a = list(range(1, 33))
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    eng.add_request(Request(a + [40], max_new_tokens=4))
    eng.run()
    rc = eng.block_rc.copy()
    free = sorted(eng.free_blocks)

    def boom(*args):
        raise _Boom()
    monkeypatch.setattr(ServingEngine, where, boom)
    eng.add_request(Request(a, max_new_tokens=4))      # a hit, copied
    with pytest.raises(_Boom):
        eng.step()
    assert not eng.waiting and eng.reserved == 0
    assert (eng.block_rc == rc).all() and sorted(eng.free_blocks) == free
    assert len(eng.free_slots) == eng.B
    monkeypatch.undo()
    r = eng.add_request(Request(a + [50, 51], max_new_tokens=5))
    eng.run()
    assert r.done and len(r.output_ids) == 5
    assert eng.stats()["free_blocks"] == eng.num_blocks
