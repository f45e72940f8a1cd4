"""The port's crash-only serving against the JAX package's, on the CPU.

Every behaviour `tests/test_serving_chaos.py` pins on the JAX engine runs
here on both engines, `gpt3_tiny` with the same weights
(`models/convert.py`) and the same chaos schedule, armed on each package's
own `testing/chaos.py` by the same site names: poison after two strikes,
the invisible transient retry, NaN-prefill quarantine, a decode NaN that
evicts its slot alone (host sampling, the block ledger armed), a failed
tick, the tick watchdog, drain with its `health()` documents, the drain
deadline, export -> import bit-matching the prefix-hit path, and corrupt
exports skipped.  Then cancellation, priorities, a chunk failing behind
a chained tick, exports read across the two packages (fp32) and the
errors the guard never absorbs (the port's alone: a CUDA error, a kernel
wrapper's and the ledger's).

Streams, outcomes, strikes and the integer counters must be exactly
equal; `health()` and `drain()` documents equal but for their seconds.
The JAX engine takes its settings from flags (`serving_overlap`,
`serving_dispatch_retries`, `serving_tick_timeout_s`,
`serving_device_sampling`, `enable_nan_watchdog`, `enable_jaxsan`), the
port from constructor arguments and `flight_recorder.set_enabled`; the
overlap setting is the same on both.  The JAX engine runs with its paged
Pallas views off (`pl.load` is gone from this jax release; the dense
views are the same math).  Last, the copied pure-Python modules (chaos,
the version directories, the flight recorder, the block ledger, the
retry loop) against the JAX package's.
"""

import contextlib
import json
import os
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.checkpoint import manager as jckpt
from paddle_tpu.flags import flag_guard
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_tiny
from paddle_tpu.observability import flight_recorder as jflight
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.testing import jaxsan
from paddle_tpu_torch.distributed.checkpoint import io_retry
from paddle_tpu_torch.distributed.checkpoint import manager as tckpt
from paddle_tpu_torch.inference import graphs
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import flight_recorder as tflight
from paddle_tpu_torch.ops import _build, flash_attention, paged_attention
from paddle_tpu_torch.testing import blocksan
from paddle_tpu_torch.testing import chaos as tchaos

ENGINE = dict(max_batch=2, max_context=64, block_size=16)
JAX_FLAGS = dict(serving_pallas_prefill=False, serving_pallas_verify=False)
SYS_PROMPT = list(range(1, 40))
OVERLAP = pytest.mark.parametrize("overlap", [False, True],
                                  ids=["sync", "overlap"])
SECONDS = ("drained_s", "uptime_s", "export_s", "admit_rate_per_s",
           "ttft_p50_s", "tpot_p50_s", "path")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_tiny())
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt3_tiny(), device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    return jm, tm


class _Side:
    """One package: its engine, request and chaos module, and a context
    that applies the crash-only settings its own way."""

    def __init__(self, name, model):
        self.name, self.model = name, model
        jax = name == "jax"
        self.Request = JaxRequest if jax else Request
        self.chaos = jchaos if jax else tchaos

    @contextlib.contextmanager
    def settings(self, overlap=True, retries=0, timeout=0.0,
                 device_sampling=True, watchdog=False, ledger=False):
        """Yields the engine's constructor arguments."""
        if self.name == "jax":
            with flag_guard(serving_overlap=overlap,
                            serving_dispatch_retries=retries,
                            serving_tick_timeout_s=timeout,
                            serving_device_sampling=device_sampling,
                            enable_nan_watchdog=watchdog,
                            enable_jaxsan=ledger, **JAX_FLAGS):
                yield {}
            return
        old = tflight.set_enabled(watchdog)
        try:
            yield dict(device="cpu", overlap=overlap,
                       dispatch_retries=retries, tick_timeout_s=timeout,
                       device_sampling=device_sampling, blocksan=ledger)
        finally:
            tflight.set_enabled(old)

    def engine(self, kw, **engine_kw):
        cls = JaxEngine if self.name == "jax" else ServingEngine
        return cls(self.model, **{**ENGINE, **engine_kw, **kw})


def _sides(models):
    return [_Side("jax", models[0]), _Side("torch", models[1])]


def _record(eng, reqs):
    """What must be equal on both engines."""
    st = eng.stats()
    keys = ("steps", "ticks", "tokens_out", "free_blocks", "reserved",
            "tick_errors", "poisoned_requests", "dispatch_retries",
            "draining", "prefill_chunks", "waiting", "prefilling")
    out = {k: st[k] for k in keys}
    out["free_all"] = st["free_blocks"] == eng.num_blocks
    out["prefix_cache"] = st.get("prefix_cache")
    out["streams"] = [list(r.output_ids) for r in reqs]
    out["outcomes"] = [r.outcome for r in reqs]
    out["strikes"] = [r._strikes for r in reqs]
    out["finished"] = [reqs.index(r) for r in eng.finished if r in reqs]
    return out


def _strip(doc):
    """A health or drain document without its seconds and paths."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in SECONDS}
    return doc


def _both(models, body):
    """``body(side)`` on each package; returns [jax, torch] results."""
    return [body(side) for side in _sides(models)]


# --------------------------------------------------- poison and retries

@OVERLAP
def test_poison_after_two_dispatch_strikes(models, overlap):
    """A request whose prompt program raises is queued again once, then
    quarantined `poisoned`; the loop survives, no block leaks, and the
    engine then serves a healthy request."""
    def body(side):
        with side.settings(overlap=overlap) as kw:
            eng = side.engine(kw)
            bad = eng.add_request(side.Request([5, 6, 7], max_new_tokens=4))
            with side.chaos.fail_at("serving.prefill.dispatch",
                                    on_calls=[1, 2],
                                    exc=RuntimeError) as fault:
                eng.run()
            ok = eng.add_request(side.Request([5, 6, 8], max_new_tokens=5))
            eng.run()
        return fault.fires, _record(eng, [bad, ok])
    (jf, want), (tf, got) = _both(models, body)
    assert got == want and tf == jf == 2
    assert got["outcomes"] == ["poisoned", "finished"]
    assert got["strikes"] == [2, 0] and got["tick_errors"] == 2
    assert got["poisoned_requests"] == 1 and got["free_all"]
    assert got["streams"][0] == []


@pytest.mark.parametrize("site,overlap", [
    ("serving.prefill.dispatch", False), ("serving.tick.dispatch", True)],
    ids=["prefill-sync", "tick-overlap"])
def test_transient_retry_is_invisible(models, overlap, site):
    """One transient failure under `dispatch_retries` retries in place:
    the stream equals a run without it, the retry is counted, nothing is
    struck or evicted."""
    def body(side, inject):
        with side.settings(overlap=overlap, retries=2) as kw:
            eng = side.engine(kw, steps_per_tick=2)
            reqs = [eng.add_request(side.Request([5 + i, 6, 7],
                                                 max_new_tokens=5))
                    for i in range(2)]
            if inject:
                with side.chaos.fail_at(site, on_calls=[1],
                                        exc=RuntimeError) as fault:
                    eng.run()
                assert fault.fires == 1
            else:
                eng.run()
        return _record(eng, reqs)
    ref = body(_sides(models)[1], False)
    want, got = _both(models, lambda side: body(side, True))
    assert got == want
    assert got["streams"] == ref["streams"]
    assert got["dispatch_retries"] == 1 and got["tick_errors"] == 0
    assert got["outcomes"] == ["finished"] * 2


def test_nan_prefill_is_quarantined_and_the_batch_isolated(models):
    """NaN prompt logits (the watchdog on) strike the poisoned request
    twice; a healthy request in the same engine streams as in a run
    without it, and the poisoned prompt never enters the prefix index."""
    def body(side, inject):
        with side.settings(watchdog=True) as kw:
            eng = side.engine(kw, prefix_cache=True)
            bad = eng.add_request(side.Request([9] * 20, max_new_tokens=4))
            ok = eng.add_request(side.Request([5] * 18 + [6, 7],
                                              max_new_tokens=4))
            fires = 0
            if inject:
                with side.chaos.nan_logits("serving.prefill",
                                           rids=[bad.rid]) as f:
                    eng.run()
                fires = f.fires
            else:
                eng.run()
        rec = _record(eng, [bad, ok])
        rec["bad_indexed"] = eng.prefix.lookup(bad.prompt_ids).blocks
        return fires, rec
    _, ref = body(_sides(models)[1], False)
    (jf, want), (tf, got) = _both(models, lambda side: body(side, True))
    assert got == want and jf == tf == 2
    assert got["outcomes"] == ["poisoned", "finished"]
    assert got["streams"][1] == ref["streams"][1] and got["bad_indexed"] == []
    assert got["free_all"] and got["reserved"] == 0


@pytest.mark.parametrize("sampled,overlap", [(False, False), (True, True)],
                         ids=["greedy-sync", "sampled-overlap"])
def test_decode_nan_evicts_only_its_slot(models, overlap, sampled):
    """Host sampling (`device_sampling` off): NaN decode logits on one
    slot end that request `error` after its first token, its blocks
    released (the ledger armed and verified), and every other slot's
    stream equals a run without the fault; a sampled row is sampled on
    the host from the same draws as the JAX engine's."""
    def body(side, inject):
        with side.settings(overlap=overlap, device_sampling=False,
                           watchdog=True, ledger=True) as kw:
            eng = side.engine(kw, max_batch=3, steps_per_tick=1)
            reqs = [eng.add_request(side.Request(
                [5 + i, 6, 7], max_new_tokens=6,
                do_sample=sampled and i == 2, temperature=0.9, top_k=40,
                seed=31 + i)) for i in range(3)]
            if inject:
                with side.chaos.nan_logits("serving.decode",
                                           rids=[reqs[1].rid]):
                    eng.run()
            else:
                eng.run()
            led = eng._blocksan
        return _record(eng, reqs), led.verifies
    ref, _ = body(_sides(models)[1], False)
    (want, jv), (got, tv) = _both(models, lambda side: body(side, True))
    assert got == want
    assert got["outcomes"] == ["finished", "error", "finished"]
    assert len(got["streams"][1]) == 1
    assert [got["streams"][i] for i in (0, 2)] == \
        [ref["streams"][i] for i in (0, 2)]
    assert got["free_all"] and got["reserved"] == 0 and tv > 0 and jv > 0


@OVERLAP
def test_tick_failure_evicts_the_slots_it_covered(models, overlap):
    """A whole-batch tick that raises names no slot: every slot it covered
    ends `error`, and the ledger reconciles at the end."""
    def body(side):
        with side.settings(overlap=overlap, ledger=True) as kw:
            eng = side.engine(kw)
            reqs = [eng.add_request(side.Request([5 + i, 6, 7],
                                                 max_new_tokens=6))
                    for i in range(2)]
            with side.chaos.fail_at("serving.tick.dispatch", on_calls=[1],
                                    exc=RuntimeError) as f:
                eng.run()
            assert f.fires == 1
        return _record(eng, reqs), eng._blocksan.verifies
    (want, _), (got, verifies) = _both(models, body)
    assert got == want
    assert got["outcomes"] == ["error", "error"]
    assert got["tick_errors"] == 1 and got["free_all"] and verifies > 0
    assert all(len(s) >= 1 for s in got["streams"])


def test_tick_watchdog_fails_a_hung_harvest(models):
    """A harvest stalled past `tick_timeout_s` fails the tick (`error`,
    blocks released) and `run()` returns; with the watchdog off the same
    stall only slows the harvest."""
    def body(side):
        with side.settings(timeout=0.3) as kw:
            eng = side.engine(kw)
            req = eng.add_request(side.Request([5, 6, 7], max_new_tokens=6))
            with side.chaos.delay_at("serving.harvest", 1.0,
                                     on_calls=[1]) as f:
                eng.run()
            assert f.fires == 1
        with side.settings() as kw:
            eng2 = side.engine(kw)
            r2 = eng2.add_request(side.Request([5, 6, 7], max_new_tokens=2))
            with side.chaos.delay_at("serving.harvest", 0.05):
                eng2.run()
        return _record(eng, [req]), r2.outcome
    (want, jo), (got, to) = _both(models, body)
    assert got == want and jo == to == "finished"
    assert got["outcomes"] == ["error"] and got["tick_errors"] == 1
    assert got["free_all"]


# ---------------------------------------------------------------- drain

def test_drain_cancels_waiting_and_closes_admission(models):
    """No admitted work: the waiting queue ends `drained`, admission
    raises, `health()` reports the drain with its counts."""
    def body(side):
        with side.settings() as kw:
            eng = side.engine(kw)
            before = eng.health()
            eng.run()
            ready = eng.health()
            waiting = [eng.add_request(side.Request([5, 6, 7],
                                                    max_new_tokens=4))
                       for _ in range(2)]
            eng.request_drain()
            draining = eng.health()
            with pytest.raises(ValueError, match="draining"):
                eng.add_request(side.Request([1, 2], max_new_tokens=2))
            info = eng.drain(deadline_s=5.0)
            assert eng.drain() is info
            after = eng.health()
        st = eng.stats()
        return (before, _strip(ready), draining, _strip(info),
                _strip(after), [r.outcome for r in waiting],
                _strip(st["drain"]), st["draining"], _record(eng, waiting))
    want, got = _both(models, body)
    assert got == want
    assert got[2] == {"ready": False, "reason": "draining", "in_flight": 0,
                      "waiting": 2, "prefilling": 0}
    assert got[3] == {"deadline_s": 5.0, "cancelled_waiting": 2,
                      "evicted_running": 0, "export": None}
    assert got[5] == ["drained", "drained"] and got[7] is True


@pytest.mark.parametrize("deadline", [30.0, 0.0], ids=["finish", "deadline"])
def test_drain_finishes_in_flight_or_evicts_at_the_deadline(models,
                                                            deadline):
    """An admitted request finishes inside the drain's deadline (the
    ledger armed: the drained engine reconciles), or, past a deadline of
    0, is evicted `drained` with its blocks released."""
    def body(side):
        with side.settings(ledger=True) as kw:
            eng = side.engine(kw)
            req = eng.add_request(side.Request([5, 6, 7], max_new_tokens=6))
            eng.step()
            assert req.slot is not None and not req.done
            info = eng.drain(deadline_s=deadline)
            verifies = eng._blocksan.verifies
        return _strip(info), _record(eng, [req]), verifies
    want, got = _both(models, body)
    assert got[:2] == want[:2] and got[2] > 0
    if deadline:
        assert got[1]["outcomes"] == ["finished"]
        assert len(got[1]["streams"][0]) == 6
        assert got[0]["evicted_running"] == 0
    else:
        assert got[1]["outcomes"] == ["drained"]
        assert got[0]["evicted_running"] == 1
    assert got[1]["free_all"]


def test_serve_forever_drains_on_sigterm(models):
    """`serve_forever` on the main thread: requests added from another
    thread finish as in `run()`, a cancelled one ends `cancelled`, and
    SIGTERM drains the engine and returns; the signal's old handler comes
    back."""
    _, tm = models
    ref = ServingEngine(tm, device="cpu", **ENGINE)
    want = ref.add_request(Request([5, 6, 7], max_new_tokens=5))
    ref.run()
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    stop = threading.Event()
    out = {}

    def client():
        deadline = time.monotonic() + 30
        while not eng.ready and time.monotonic() < deadline:
            time.sleep(0.005)
        r = eng.add_request(Request([5, 6, 7], max_new_tokens=5))
        c = eng.add_request(Request([9, 9, 9], max_new_tokens=40))
        c.cancel()
        while not (r.done and c.outcome) and time.monotonic() < deadline:
            time.sleep(0.005)
        out["reqs"] = (r, c)
        os.kill(os.getpid(), signal.SIGTERM)
    handler = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=client, daemon=True)
    timer = threading.Timer(60, stop.set)
    timer.start()
    t.start()
    try:
        eng.serve_forever(stop)
    finally:
        timer.cancel()
        stop.set()
    t.join(10)
    assert not t.is_alive() and signal.getsignal(signal.SIGTERM) is handler
    r, c = out["reqs"]
    assert r.outcome == "finished" and r.output_ids == want.output_ids
    assert c.outcome == "cancelled"
    info = eng.stats()["drain"]
    assert info["cancelled_waiting"] == 0 and info["evicted_running"] == 0
    assert eng.health()["reason"] == "draining"
    assert eng.stats()["free_blocks"] == eng.num_blocks


# ----------------------------------------------------- export and import

def _serve_one(eng, req_cls, suffix, n=6):
    r = eng.add_request(req_cls(SYS_PROMPT + suffix, max_new_tokens=n))
    eng.run()
    return r


def _export_hit(side, root):
    """Serve the system prompt with a suffix, then another (the warm
    prefix-hit path), drain, export under ``root``."""
    with side.settings() as kw:
        a = side.engine(kw, max_context=96, prefix_cache=True,
                        prefix_export_dir=root)
        _serve_one(a, side.Request, [77])
        hit = _serve_one(a, side.Request, [88])
        assert a.stats()["prefix_cache"]["hits"] == 1
        info = a.drain()
        # the export side of a handoff: the exported blocks go back
        info = dict(info, released=a.release_exported_prefix(),
                    free=a.stats()["free_blocks"] == a.num_blocks == len(
                        a.free_blocks))
    return hit, info


def _import_hit(side, root):
    with side.settings(ledger=True) as kw:
        b = side.engine(kw, max_context=96, prefix_cache=True,
                        prefix_export_dir=root)
        imp = b.stats()["prefix_cache"]["import"]
        rb = _serve_one(b, side.Request, [88])
        st = b.stats()
    assert st["free_blocks"] == b.num_blocks
    return imp, rb, st


def test_export_then_import_bit_matches_the_prefix_hit_path(models,
                                                            tmp_path):
    """drain -> export -> a new engine imports: a cached-prefix prompt
    streams exactly as the warm engine's prefix hit did, the import took
    its blocks through the ordinary accounting (the ledger armed), and
    nothing leaks."""
    def body(side):
        root = str(tmp_path / side.name)
        hit, info = _export_hit(side, root)
        exp = info["export"]
        assert os.path.exists(os.path.join(exp["path"], "COMPLETE"))
        imp, rb, st = _import_hit(side, root)
        return (_strip(info), hit.output_ids, imp, rb.output_ids,
                st["prefix_cache"])
    want, got = _both(models, body)
    assert got == want
    assert got[0]["export"]["entries"] == got[0]["export"]["blocks"] == 2
    assert got[0]["released"] == 2 and got[0]["free"]
    assert got[2] == {"step": 1, "blocks": 2, "skipped_corrupt": 0}
    assert got[3] == got[1] and got[4]["hits"] == 1


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_fp32_exports_cross_the_packages(models, tmp_path, direction):
    """An fp32 export written by one package is imported by the other:
    the same fingerprint, the same files, and the importer's prefix-hit
    stream equals the exporter's."""
    jax_side, torch_side = _sides(models)
    src, dst = (jax_side, torch_side) if direction == "jax_to_torch" \
        else (torch_side, jax_side)
    root = str(tmp_path / "x")
    hit, _ = _export_hit(src, root)
    imp, rb, st = _import_hit(dst, root)
    assert imp == {"step": 1, "blocks": 2, "skipped_corrupt": 0}
    assert rb.output_ids == hit.output_ids
    assert st["prefix_cache"]["hits"] == 1


def test_corrupt_exports_are_skipped(models, tmp_path):
    """Versions hand-built through the commit helper: the newest, with
    flipped bytes, is skipped and counted, the older valid one imported
    (its bytes, never the corrupt one's), by both engines; a fingerprint
    mismatch is skipped too."""
    jm, tm = models
    root = str(tmp_path / "c")
    probe = ServingEngine(tm, device="cpu", prefix_cache=True, **ENGINE)
    meta = probe._prefix_fingerprint()
    jprobe = JaxEngine(jm, prefix_cache=True, **ENGINE)
    assert meta == jprobe._prefix_fingerprint()
    nh, _, bs, hd = probe.pools[0][0].shape
    layers = tm.cfg.num_layers

    def fabricate(step, n_entries):
        index = {"schema": "paddle_tpu.prefix/v1", "block_size": bs,
                 "meta": meta,
                 "entries": [{"hash": f"{i:02d}" * 16, "parent": None,
                              "block": i + 1} for i in range(n_entries)]}
        arrays = {"block_ids": np.arange(1, n_entries + 1, dtype=np.int64)}
        for li in range(layers):
            arrays[f"k{li}"] = np.full((nh, n_entries, bs, hd), step,
                                       np.float32)
            arrays[f"v{li}"] = np.full((nh, n_entries, bs, hd), -step,
                                       np.float32)

        def write(d):
            with open(os.path.join(d, "prefix_index.json"), "w") as f:
                json.dump(index, f)
            with open(os.path.join(d, "prefix_blocks.npz"), "wb") as f:
                np.savez(f, **arrays)
            return ["prefix_index.json", "prefix_blocks.npz"]
        return tckpt.commit_single_rank(root, step, write)

    fabricate(1, 1)
    newest = fabricate(2, 2)
    tchaos.flip_bytes(os.path.join(newest, "prefix_blocks.npz"), 64, 8)
    eng = ServingEngine(tm, device="cpu", prefix_cache=True,
                        prefix_export_dir=root, **ENGINE)
    jeng = JaxEngine(jm, prefix_cache=True, prefix_export_dir=root, **ENGINE)
    imp = eng.stats()["prefix_cache"]["import"]
    assert imp == jeng.stats()["prefix_cache"]["import"] == \
        {"step": 1, "blocks": 1, "skipped_corrupt": 1}
    blk = eng.prefix.resident_blocks()[0]
    assert float(eng.pools[0][0][:, blk].reshape(-1)[0]) == 1.0
    evs = [e for e in tflight.default_recorder().events()
           if e["kind"] == "prefix_import_skip"]
    assert evs and evs[-1]["step"] == 2
    # a fingerprint mismatch: skipped with its own reason
    shutil.rmtree(newest)

    def write_mismatch(d):
        with open(os.path.join(d, "prefix_index.json"), "w") as f:
            json.dump({"meta": dict(meta, quant="int8"), "entries": []}, f)
        with open(os.path.join(d, "prefix_blocks.npz"), "wb") as f:
            np.savez(f, block_ids=np.asarray([1], np.int64))
        return ["prefix_index.json", "prefix_blocks.npz"]
    tckpt.commit_single_rank(root, 3, write_mismatch)
    eng2 = ServingEngine(tm, device="cpu", prefix_cache=True,
                         prefix_export_dir=root, **ENGINE)
    jeng2 = JaxEngine(jm, prefix_cache=True, prefix_export_dir=root,
                      **ENGINE)
    assert eng2.stats()["prefix_cache"]["import"] == \
        jeng2.stats()["prefix_cache"]["import"] == \
        {"step": 1, "blocks": 1, "skipped_corrupt": 1}
    evs = [e for e in tflight.default_recorder().events()
           if e["kind"] == "prefix_import_skip"]
    assert evs[-1]["reason"] == "engine fingerprint mismatch"


@pytest.mark.parametrize("fault", ["dtype", "shape", "block"])
def test_a_malformed_export_changes_nothing(models, tmp_path, fault):
    """A version whose manifest holds but whose arrays do not fit the
    engine (another type, another shape, an entry's block missing) is
    skipped before the index changes: the older version imports alone
    and every other block stays free.  (The JAX engine rebuilds its index
    before it reads the arrays; this check is the port's.)"""
    _, tm = models
    root = str(tmp_path / "m")
    probe = ServingEngine(tm, device="cpu", prefix_cache=True, **ENGINE)
    meta = probe._prefix_fingerprint()
    nh, _, bs, hd = probe.pools[0][0].shape

    def commit(step, n, dtype=np.float32, shape_bs=bs, ids=None):
        index = {"schema": "paddle_tpu.prefix/v1", "block_size": bs,
                 "meta": meta,
                 "entries": [{"hash": f"{step}{i:02d}" * 8, "parent": None,
                              "block": i + 1} for i in range(n)]}
        arrays = {"block_ids": np.arange(1, n + 1, dtype=np.int64)
                  if ids is None else ids}
        for li in range(tm.cfg.num_layers):
            for name in "kv":
                arrays[f"{name}{li}"] = np.full((nh, n, shape_bs, hd), step,
                                                dtype)

        def write(d):
            with open(os.path.join(d, "prefix_index.json"), "w") as f:
                json.dump(index, f)
            with open(os.path.join(d, "prefix_blocks.npz"), "wb") as f:
                np.savez(f, **arrays)
            return ["prefix_index.json", "prefix_blocks.npz"]
        tckpt.commit_single_rank(root, step, write)

    commit(1, 1)
    commit(2, 3, **{"dtype": dict(dtype=np.float64),
                    "shape": dict(shape_bs=bs // 2),
                    "block": dict(ids=np.arange(2, 5, dtype=np.int64))}[
                        fault])
    eng = ServingEngine(tm, device="cpu", prefix_cache=True, blocksan=True,
                        prefix_export_dir=root, **ENGINE)
    assert eng.stats()["prefix_cache"]["import"] == \
        {"step": 1, "blocks": 1, "skipped_corrupt": 1}
    assert len(eng.prefix) == 1
    assert len(eng.free_blocks) == eng.num_blocks - 1
    blk = eng.prefix.resident_blocks()[0]
    assert float(eng.pools[0][0][:, blk].reshape(-1)[0]) == 1.0
    blocksan.blocksan_verify(eng)


# ----------------------------------------------- cancel and priorities

@pytest.mark.parametrize("where", ["waiting", "prefilling", "running"])
def test_cancel(models, where):
    """`cancel()` acts at the next boundary: a waiting request is dropped,
    a chunked admission aborted mid-prompt, a running request evicted;
    each ends `cancelled` with its blocks back, and the other request
    streams on."""
    def body(side):
        with side.settings() as kw:
            eng = side.engine(kw, max_batch=1, num_blocks=8,
                              steps_per_tick=2,
                              prefill_chunk=16 if where == "prefilling"
                              else 0)
            other = side.Request(list(range(3, 23)), max_new_tokens=6)
            target = side.Request(list(range(50, 90)), max_new_tokens=12)
            first, second = (other, target) if where == "waiting" \
                else (target, other)
            eng.add_request(first)
            eng.add_request(second)
            eng.step()
            if where == "running":
                eng.step()
            target.cancel()
            eng.run()
        return _record(eng, [other, target])
    want, got = _both(models, body)
    assert got == want
    assert got["outcomes"] == ["finished", "cancelled"]
    assert got["free_all"] and got["reserved"] == 0
    n = len(got["streams"][1])
    assert n == {"waiting": 0, "prefilling": 0, "running": 5}[where]


def test_priorities_order_admissions(models):
    """The highest priority waiting request is admitted first, FIFO
    within a priority."""
    def body(side):
        with side.settings() as kw:
            eng = side.engine(kw, max_batch=1)
            reqs = [eng.add_request(side.Request([5 + i, 6, 7],
                                                 max_new_tokens=3,
                                                 priority=p))
                    for i, p in enumerate((0, 1, 0, 2, 1))]
            eng.run()
        return _record(eng, reqs)
    want, got = _both(models, body)
    assert got == want and got["finished"] == [3, 1, 4, 0, 2]


def test_a_chunk_failing_behind_a_chained_tick_drops_both_ticks(models):
    """The overlapped loop runs non-final chunks behind a chained tick;
    one that fails strikes its own request, and the two ticks in flight
    are dropped unharvested, their tokens with them, as in the JAX
    engine: streams, strikes and counters equal the JAX engine's."""
    def body(side):
        with side.settings() as kw:
            eng = side.engine(kw, prefill_chunk=16, steps_per_tick=2)
            a = eng.add_request(side.Request([5, 6, 7], max_new_tokens=20))
            b = eng.add_request(side.Request(list(range(100, 150)),
                                             max_new_tokens=6))
            with side.chaos.fail_at("serving.prefill.dispatch",
                                    on_calls=[3], exc=RuntimeError) as f:
                eng.run()
        chunks = getattr(eng, "overlap_chunks_total" if side.name == "jax"
                         else "overlap_chunks")
        return _record(eng, [a, b]), f.fires, chunks
    (want, jfires, jchunks), (got, fires, chunks) = _both(models, body)
    assert got == want and fires == jfires == 1
    assert chunks == jchunks > 0
    assert got["outcomes"] == ["finished", "finished"]
    assert got["strikes"] == [0, 1]
    assert got["tick_errors"] == 1 and got["free_all"]


# ------------------------------------------------ errors that propagate

class _FailingLibrary:
    """The kernel library as a launch that returns a CUDA error sees it."""

    @staticmethod
    def ptt_error_string(err):
        return b"an illegal memory access was encountered"


def _kernel_fault(kind, kernel):
    """A plain version that fails as its kernel's wrapper does on the
    card: the launch's error code through `_build.check`, or arguments
    refused by `_build.check_device_tensors`."""
    def plain(q, *args, **kwargs):
        if kind == "launch":
            _build.check(700, kernel)
        _build.check_device_tensors(kernel, (q[..., ::2],))
    return plain


@pytest.mark.parametrize("kind", ["cuda", "ledger", "launch", "arguments"])
@pytest.mark.parametrize("program", ["prefill", "tick"])
def test_loud_errors_propagate_unretried(models, monkeypatch, kind,
                                         program):
    """A CUDA error (sticky: the context is lost), a kernel wrapper's
    failed launch or refused arguments, or a ledger finding from a program
    is never absorbed and never retried, whatever `dispatch_retries` says:
    it leaves `run()`, uncounted."""
    _, tm = models
    calls = []
    if kind in ("cuda", "ledger"):
        exc = torch.AcceleratorError if kind == "cuda" \
            else blocksan.BlocksanError
        replay = graphs.Program.replay

        def failing(prog):
            if ("ids" in prog.inputs) == (program == "prefill"):
                calls.append(1)
                raise exc("injected")
            return replay(prog)
        monkeypatch.setattr(graphs.Program, "replay", failing)
    else:
        exc = _build.KernelLaunchError if kind == "launch" \
            else _build.KernelValueError
        mod, name, kernel = (
            (flash_attention, "flash_attention_fwd_reference", "flash_fwd")
            if program == "prefill" else
            (paged_attention, "paged_attention_reference", "paged_decode"))
        fault = _kernel_fault(kind, kernel)

        def failing(*args, **kwargs):
            calls.append(1)
            fault(*args, **kwargs)
        monkeypatch.setattr(_build, "library", _FailingLibrary)
        monkeypatch.setattr(mod, name, failing)
    eng = ServingEngine(tm, device="cpu", dispatch_retries=3, **ENGINE)
    eng.add_request(Request([5, 6, 7], max_new_tokens=4))
    with pytest.raises(exc):
        eng.run()
    assert len(calls) == 1
    assert eng.dispatch_retries == 0 and eng.tick_errors == 0


# ----------------------------------------------- the copied modules

@pytest.mark.parametrize("kind", ["site", "nan", "delay", "open",
                                  "truncate"])
def test_chaos_fires_like_the_jax_module(tmp_path, kind):
    """The same schedule on both chaos modules fires on the same calls."""
    def drive(mod, tag):
        fired = []
        if kind == "site":
            with mod.fail_at("s.x", on_calls=[2, 3], exc=ValueError) as f:
                for _ in range(4):
                    try:
                        mod.inject("s.x")
                        mod.inject("s.y")
                        fired.append(0)
                    except ValueError:
                        fired.append(1)
                with pytest.raises(RuntimeError, match="already armed"):
                    with mod.fail_at("s.x"):
                        pass
        elif kind == "nan":
            with mod.nan_logits("serving.decode", slots=[1], rids=[9],
                                on_calls=[1, 3]) as f:
                for slot, rid in ((0, 1), (1, 2), (0, 9), (1, 9), (2, 3)):
                    fired.append(mod.nan_payload("serving.decode", slot=slot,
                                                 rid=rid))
                    fired.append(mod.nan_payload("serving.prefill",
                                                 slot=slot, rid=rid))
        elif kind == "delay":
            with mod.delay_at("serving.harvest", 0.01, on_calls=[2]) as f:
                for _ in range(3):
                    t = time.monotonic()
                    mod.maybe_delay("serving.harvest")
                    fired.append(time.monotonic() - t >= 0.01)
        else:
            path = tmp_path / f"{tag}_data.bin"
            ctx = mod.fail_open("data", on_calls=[1]) if kind == "open" \
                else mod.truncate_writes("data", 5)
            with ctx as f:
                try:
                    with mod.checked_open(path, "wb") as fh:
                        fh.write(b"0123456789")
                    fired.append("wrote")
                except OSError:
                    fired.append("raised")
            fired.append(path.read_bytes() if path.exists() else None)
        assert mod.active_faults() == 0
        return fired, f.calls, f.fires
    assert drive(tchaos, "t") == drive(jchaos, "j")


def test_chaos_corrupts_files_like_the_jax_module(tmp_path):
    data = bytes(range(32))
    for mod, name in ((tchaos, "t"), (jchaos, "j")):
        p = tmp_path / name
        p.write_bytes(data)
        mod.flip_bytes(str(p), 4, 3)
        mod.truncate_file(str(p), 20)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    with pytest.raises(ValueError, match="past EOF"):
        tchaos.flip_bytes(str(tmp_path / "t"), 100)


@pytest.mark.parametrize("damage", ["none", "flip", "truncate", "sentinel",
                                    "manifest"])
def test_versions_read_across_the_packages(tmp_path, damage):
    """A version committed by either package verifies the same way under
    both, whole or damaged, and `latest_complete` picks the same step."""
    def write(d):
        with open(os.path.join(d, "a.bin"), "wb") as f:
            f.write(bytes(range(200)))
        return ["a.bin"]
    reasons = []
    for commit in (tckpt.commit_single_rank, jckpt.commit_single_rank):
        root = str(tmp_path / commit.__module__.split(".")[0])
        commit(root, 1, write)
        path = commit(root, 2, write)
        target = os.path.join(path, "a.bin")
        if damage == "flip":
            tchaos.flip_bytes(target, 10)
        elif damage == "truncate":
            tchaos.truncate_file(target, 100)
        elif damage == "sentinel":
            os.remove(os.path.join(path, "COMPLETE"))
        elif damage == "manifest":
            with open(os.path.join(path, "manifest_0.json"), "w") as f:
                f.write("{")
        reasons.append([(m.verify_version(path), m.latest_complete(root),
                         m.all_steps(root)) for m in (tckpt, jckpt)])
    assert reasons[0][0] == reasons[0][1] == reasons[1][0] == reasons[1][1]
    assert (reasons[0][0][0] is None) == (damage == "none")
    assert reasons[0][0][1] == (2 if damage == "none" else 1)


def test_commit_retries_a_transient_write_failure(tmp_path):
    """A write that fails once restarts the version from scratch; the
    committed version verifies."""
    def write(d):
        with tchaos.checked_open(os.path.join(d, "a.bin"), "wb") as f:
            f.write(b"x" * 64)
        return ["a.bin"]
    with tchaos.fail_open("a.bin", on_calls=[1]) as f:
        path = tckpt.commit_single_rank(str(tmp_path), 1, write,
                                        backoff=0.0)
    assert f.fires == 1 and tckpt.verify_version(path) is None
    assert jckpt.verify_version(path) is None


@pytest.mark.parametrize("never", [False, True])
def test_call_with_retries(never):
    seen, slept = [], []

    class Counter:
        def inc(self, **labels):
            seen.append(labels)

    def fn():
        if len(slept) < 2:
            raise torch.AcceleratorError("x") if never else RuntimeError("x")
        return "ok"
    kw = dict(retries=3, backoff_s=0.5, site="s", retry_on=(RuntimeError,),
              never=(torch.AcceleratorError,), counter=Counter(),
              sleep=slept.append)
    if never:
        with pytest.raises(torch.AcceleratorError):
            io_retry.call_with_retries(fn, **kw)
        assert seen == [] and slept == []
    else:
        assert io_retry.call_with_retries(fn, **kw) == "ok"
        assert slept == [0.5, 1.0] and seen == [{"site": "s"}] * 2


def test_flight_recorder_matches_the_jax_recorder(tmp_path):
    """Off, the watchdog never touches its value; on, the first
    non-finite site is kept and dumped; the ring is bounded; the dump's
    keys are the JAX recorder's, its metrics the registry's snapshot."""
    class Untouchable:
        def __float__(self):
            raise AssertionError("read while off")
    assert not tflight.enabled()
    assert tflight.check_finite(Untouchable(), site="x")
    rec = tflight.FlightRecorder(capacity=3)
    jrec = jflight.FlightRecorder(capacity=3)
    for r in (rec, jrec):
        for i in range(5):
            r.record_event("e", i=i)
            r.record_step({"step": i})
    assert [e["i"] for e in rec.events()] == \
        [e["i"] for e in jrec.events()] == [2, 3, 4]
    old = tflight.set_enabled(True)
    try:
        assert tflight.check_finite(1.0, site="a", recorder=rec)
        assert not tflight.check_finite(float("nan"), site="b", step=7,
                                        recorder=rec)
        assert not tflight.check_finite(float("inf"), site="c",
                                        recorder=rec)
    finally:
        tflight.set_enabled(old)
    assert rec.first_nonfinite["site"] == "b"
    assert rec.first_nonfinite["step"] == 7
    doc = rec.dump(str(tmp_path / "d.json"))
    jdoc = jrec.snapshot()
    # the dump carries the port's registry, as the JAX one carries its own
    from paddle_tpu_torch.observability import metrics as tmetrics
    assert set(doc) == set(jdoc) - {"xray"}
    assert doc["metrics"] == tmetrics.snapshot()
    assert json.loads((tmp_path / "d.json").read_text())["reason"] == \
        "manual"


class _Engine:
    """The structures the ledger reconciles, for one block per slot."""

    def __init__(self, n):
        self.num_blocks = n
        self.block_rc = np.zeros((n + 1,), np.int64)
        self.free_blocks = list(range(1, n + 1))
        self.tables = np.zeros((2, 2), np.int32)
        self.slot_req = [None, None]
        self.prefix = None
        self.pools = [(torch.zeros((1, n + 1, 2, 2)),
                       torch.zeros((1, n + 1, 2, 2)))]
        self.dpools = None


@pytest.mark.parametrize("fault", ["double_release", "untracked_reference",
                                   "free_list_corrupt", "block_leak",
                                   "accounting_mismatch"])
def test_block_ledger_finds_what_the_jax_ledger_finds(fault):
    """One bookkeeping fault each, on the port's ledger and the JAX one:
    the same kind of finding, raised as each package's error."""
    def drive(mod, error):
        eng = _Engine(4)
        led = mod.block_ledger(4) if mod is jaxsan else \
            mod.block_ledger(4, True)
        eng._blocksan = led

        def alloc():
            blk = eng.free_blocks.pop(0)
            led.alloc(blk)
            eng.block_rc[blk] = 1
            return blk
        with pytest.raises(error) as info:
            b = alloc()
            eng.tables[0, 0] = b
            mod.blocksan_verify(eng)           # clean so far
            if fault == "double_release":
                led.release(b)
                led.release(b)
            elif fault == "untracked_reference":
                led.ref(3)
            elif fault == "free_list_corrupt":
                eng.free_blocks.append(2)
                mod.blocksan_verify(eng)
            elif fault == "block_leak":
                eng.tables[0, 0] = 0
                mod.blocksan_verify(eng)
            else:
                eng.block_rc[b] = 2
                mod.blocksan_verify(eng)
        return str(info.value).split("]")[0]
    with flag_guard(enable_jaxsan=True):
        want = drive(jaxsan, jaxsan.JaxsanError)
    assert drive(blocksan, blocksan.BlocksanError) == want == \
        f"blocksan [{fault}"
