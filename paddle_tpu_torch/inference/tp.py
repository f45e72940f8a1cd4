"""Tensor-parallel serving: one model over ``tp`` ranks.

Counterpart of ``paddle_tpu/inference/tp.py``.  There the engine's
programs become ``shard_map`` programs over a 'tp' mesh axis.  Here each
rank is a process (rank 0 is the engine's own, the others are started by
it: ``inference/tp_worker.py``), joined in a process group of their own
(``distributed/collective.private_group``), and every rank runs the same
program on its shards.  The host scheduler stays on rank 0: each dispatch
sends the program's key and inputs (tables, lengths, last tokens,
sampling parameters, seeds, positions) to the other ranks by broadcast
(:class:`TPProgram`, :class:`TPWorld`), so none of the scheduler changes
with the degree.

THE BIT-PARITY CONTRACT (the JAX file's).  No contraction dimension is
split: every product is column-parallel (a rank computes exact column
slices of the full product), attention is per head (heads are a batch
axis), activations are re-replicated by ``all_gather`` in rank order,
never by a row-parallel all-reduce (which would reorder the float sums),
and the vocab-parallel embedding sums one nonzero row against exact
zeros.  Token choice sees the full replicated logits.  Whether a column
slice of a product rounds like the full product is the BLAS library's
choice of algorithm; the layout never asks for a different sum.

The plan (:func:`build_plan`) keeps the JAX layout, so a rank's shards
(:func:`shard_plan`) equal the JAX plan's slices as arrays: ``qkv_w``
``[H, 3, nh, hd]`` sliced by heads, ``proj_w`` / ``fc1_w`` / ``fc2_w``
``[in, out]`` by output columns, ``wte`` ``[V, H]`` by vocabulary rows;
norms and ``wpe`` whole.  :class:`TPShardModel` turns one rank's shards
into ``nn.Linear``'s layout and serves them through
``forward_with_cache`` over the views the engine's programs build on the
rank's pools (sharded on the head axis: ``[nh / tp, blocks, bs, hd]``),
so on the card attention launches ``paged_decode``, ``paged_chunk`` and
``flash_fwd`` at ``nh / tp`` heads.  A quantized plan
(``inference/quant.quantize_plan``) runs its products on the weight-only
route, each rank on its column shard.

Scope: GPT-family models (``models/gpt.py``); anything else raises the
JAX file's errors and serves at degree 1.  Programs run eagerly at a
degree above 1 (a gloo collective cannot be captured in a CUDA graph).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..distributed import collective as _coll
from ..models.kv_cache import PagedKVCache
from . import graphs
from .quant import WeightOnlyEmbedding, WeightOnlyLinear

__all__ = ["TPPlan", "build_plan", "shard_plan", "forward_tp",
           "TPShardModel", "TPProgram", "TPWorld", "TPWorkerError",
           "resolve_tp_devices"]

class TPWorkerError(RuntimeError):
    """A tensor-parallel rank died or failed: the engine cannot serve."""


class TPPlan:
    """One model's TP layout: the parameters in the JAX layout
    (``params``, torch tensors), the axis each is sharded on (``specs``;
    None = replicated) and the static dims (``meta``)."""

    def __init__(self, params: Dict[str, Any], specs: Dict[str, Any],
                 meta: Dict[str, Any]):
        self.params = params
        self.specs = specs
        self.meta = meta


def build_plan(model, tp: int) -> TPPlan:
    """The GPT-family layout for degree ``tp``, validated as the JAX
    ``build_plan`` validates it: a model without GPT's structure, MoE
    blocks, ``tensor_parallel=True`` and a head count, FFN width or
    vocabulary the degree does not divide raise ``ValueError``."""
    gpt = getattr(model, "gpt", None)
    cfg = getattr(model, "cfg", None)
    if gpt is None or cfg is None or not hasattr(gpt, "blocks") \
            or not hasattr(gpt, "wte") or not hasattr(gpt, "wpe"):
        raise ValueError(
            "tp_degree > 1 supports GPT-family models "
            f"(got {type(model).__name__}); serve this model at degree 1")
    if getattr(cfg, "moe_num_experts", 0):
        raise ValueError("tensor-parallel serving does not cover MoE "
                         "blocks; serve at degree 1")
    if getattr(cfg, "tensor_parallel", False):
        raise ValueError(
            "model was built with tensor_parallel=True (training-style "
            "sharding); the serving TP path owns its own layout - build "
            "the model with tensor_parallel=False")
    nh, H, V = cfg.num_heads, cfg.hidden_size, cfg.vocab_size
    inter = cfg.intermediate_size
    for name, dim in (("num_heads", nh), ("intermediate_size", inter),
                      ("vocab_size", V)):
        if dim % tp:
            raise ValueError(f"tp_degree={tp} must divide {name}={dim}")
    hd = H // nh

    def leaf(t):
        return t.detach()
    blocks, specs_blocks = [], []
    for blk in gpt.blocks:
        attn, mlp = blk.attn, blk.mlp
        for attr in ("qkv", "proj"):
            if not hasattr(attn, attr):
                raise ValueError("unsupported attention layout for TP "
                                 f"serving: missing attn.{attr}")
        if not hasattr(mlp, "fc1") or not hasattr(mlp, "fc2"):
            raise ValueError("unsupported MLP layout for TP serving "
                             "(expected fc1/fc2)")
        # nn.Linear keeps [out, in]; the plan keeps the JAX [in, out]
        blocks.append({
            "ln1_w": leaf(blk.ln1.weight), "ln1_b": leaf(blk.ln1.bias),
            "qkv_w": leaf(attn.qkv.weight).t().reshape(H, 3, nh, hd),
            "qkv_b": leaf(attn.qkv.bias).reshape(3, nh, hd),
            "proj_w": leaf(attn.proj.weight).t(),
            "proj_b": leaf(attn.proj.bias),
            "ln2_w": leaf(blk.ln2.weight), "ln2_b": leaf(blk.ln2.bias),
            "fc1_w": leaf(mlp.fc1.weight).t(), "fc1_b": leaf(mlp.fc1.bias),
            "fc2_w": leaf(mlp.fc2.weight).t(), "fc2_b": leaf(mlp.fc2.bias),
        })
        specs_blocks.append({
            "ln1_w": None, "ln1_b": None, "qkv_w": 2, "qkv_b": 1,
            "proj_w": 1, "proj_b": 0, "ln2_w": None, "ln2_b": None,
            "fc1_w": 1, "fc1_b": 0, "fc2_w": 1, "fc2_b": 0})
    params = {"wte": leaf(gpt.wte.weight), "wpe": leaf(gpt.wpe.weight),
              "blocks": blocks, "lnf_w": leaf(gpt.ln_f.weight),
              "lnf_b": leaf(gpt.ln_f.bias)}
    specs = {"wte": 0, "wpe": None, "blocks": specs_blocks, "lnf_w": None,
             "lnf_b": None}
    meta = {"tp": int(tp), "nh": nh, "hd": hd, "H": H, "V": V,
            "V_local": V // tp, "n_layers": cfg.num_layers,
            "max_seq_len": cfg.max_seq_len,
            "ln_eps": [(float(blk.ln1.eps), float(blk.ln2.eps))
                       for blk in gpt.blocks],
            "lnf_eps": float(gpt.ln_f.eps), "cfg": cfg}
    return TPPlan(params, specs, meta)


def _slice(t: torch.Tensor, axis, rank: int, tp: int) -> torch.Tensor:
    if axis is None:
        return t.contiguous()
    n = t.shape[axis] // tp
    return t.narrow(axis, rank * n, n).contiguous()


def shard_plan(plan: TPPlan, rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s shards of the plan, in the plan's (JAX) layout:
    each rank holds 1/tp of every sharded matrix.  A quantized leaf
    (``{"q", "s"}``) shards both members on the weight's axis (the
    scale keeps its reduced axis of size 1)."""
    tp = plan.meta["tp"]

    def place(p, s):
        if isinstance(p, list):
            return [place(a, b) for a, b in zip(p, s)]
        if isinstance(p, dict) and set(p) == {"q", "s"}:
            return {k: _slice(v, s, rank, tp) for k, v in p.items()}
        if isinstance(p, dict):
            return {k: place(p[k], s[k]) for k in p}
        return _slice(p, s, rank, tp)
    return place(plan.params, plan.specs)


def flat_shards(shards: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A shard tree as ``{dotted name: tensor}`` (what goes over the
    wire to a worker rank)."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = x
    walk("", shards)
    return out


def unflat_shards(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`flat_shards` (a worker rank's side)."""
    tree: Dict[str, Any] = {"blocks": {}}
    for name, t in flat.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    blocks = tree.pop("blocks")
    tree["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


class _Linear(nn.Module):
    """A column shard in ``nn.Linear``'s layout, run as ``F.linear``
    (the degree-1 model's call)."""

    def __init__(self, weight, bias):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class _Embedding(nn.Module):
    """A vocabulary shard of the tied embedding: lookup and head."""

    def __init__(self, weight):
        super().__init__()
        self.register_buffer("weight", weight)

    def forward(self, ids):
        return F.embedding(ids, self.weight)

    def attend(self, h):
        return F.linear(h, self.weight)


def _linear(w, b):
    """A plan leaf ``[in, out_local]`` (or its quantized pair) as a
    module in ``nn.Linear``'s layout."""
    if isinstance(w, dict):
        q = w["q"].reshape(w["q"].shape[0], -1).t().contiguous()
        return WeightOnlyLinear(q, w["s"].reshape(-1), b)
    return _Linear(w.reshape(w.shape[0], -1).t().contiguous(), b)


class TPShardModel(nn.Module):
    """One rank's model: its shards, the group, and the GPT forward of
    the JAX ``forward_tp`` behind the engine's ``forward_with_cache``
    interface.  ``pool_heads`` is the head count of the rank's pools.
    ``comm_calls`` / ``comm_bytes`` / ``comm_s`` count the forward's
    collectives (bytes this rank contributes; seconds on the host clock,
    host staging included, from when the card has produced the input);
    ``on_error`` turns a failed collective into
    the caller's error (rank 0: the dead worker's)."""

    def __init__(self, meta: Dict[str, Any], shards: Dict[str, Any],
                 group, rank: int, device):
        super().__init__()
        self.meta = {k: v for k, v in meta.items() if k != "cfg"}
        self.cfg = meta["cfg"]
        self.group = group
        self.rank = int(rank)
        tp = meta["tp"]
        self.pool_heads = meta["nh"] // tp
        dev = torch.device(device)
        shards = _to(shards, dev)
        wte = shards["wte"]
        self.wte = WeightOnlyEmbedding(wte["q"], wte["s"].reshape(-1)) \
            if isinstance(wte, dict) else _Embedding(wte)
        self.register_buffer("wpe", shards["wpe"])
        self.register_buffer("lnf_w", shards["lnf_w"])
        self.register_buffer("lnf_b", shards["lnf_b"])
        self.blocks = nn.ModuleList()
        for b in shards["blocks"]:
            m = nn.Module()
            for name in ("ln1_w", "ln1_b", "ln2_w", "ln2_b"):
                m.register_buffer(name, b[name])
            m.qkv = _linear(b["qkv_w"], b["qkv_b"].reshape(-1))
            m.proj = _linear(b["proj_w"], b["proj_b"])
            m.fc1 = _linear(b["fc1_w"], b["fc1_b"])
            m.fc2 = _linear(b["fc2_w"], b["fc2_b"])
            self.blocks.append(m)
        self.comm_calls = 0
        self.comm_bytes = 0
        self.comm_s = 0.0
        self.on_error = None

    @property
    def device(self) -> torch.device:
        return self.lnf_w.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lnf_w.dtype

    def resident_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.buffers())

    def _collective(self, fn, t):
        if t.is_cuda:
            # the clock starts when the producing kernels are done: a
            # staged collective would wait for them in its copy anyway
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        try:
            out = fn(t)
        except RuntimeError as e:
            if self.on_error is not None:
                self.on_error(e)
            raise
        self.comm_calls += 1
        self.comm_bytes += t.numel() * t.element_size()
        self.comm_s += time.perf_counter() - t0
        return out

    def _gather(self, h):
        """Re-replicate column shards: concatenate on the last axis in
        rank order."""
        return self._collective(
            lambda t: _coll.all_gather_concat(t, -1, self.group),
            h.contiguous())

    def forward_with_cache(self, input_ids, caches, pos_offset=0):
        """``(logits [B, s, V], caches)`` over this rank's shards; the
        caches are views over the rank's pools (``nh / tp`` heads)."""
        m = self.meta
        B, s = input_ids.shape
        nh_l, hd, H = m["nh"] // m["tp"], m["hd"], m["H"]
        Vl = m["V_local"]
        # vocab-parallel embedding: the owning rank's row, exact zeros on
        # the others, summed in rank order
        v0 = self.rank * Vl
        in_range = (input_ids >= v0) & (input_ids < v0 + Vl)
        rows = self.wte((input_ids - v0).clamp(0, Vl - 1))
        rows = torch.where(in_range[..., None], rows,
                           torch.zeros_like(rows))
        parts = self._collective(
            lambda t: _coll.all_gather_concat(t[None], 0, self.group), rows)
        pos = torch.arange(s, device=input_ids.device) + pos_offset
        pos = pos.clamp(max=m["max_seq_len"] - 1)
        x = parts.sum(0, dtype=rows.dtype) + F.embedding(pos, self.wpe)
        new_caches = []
        for li, (blk, view) in enumerate(zip(self.blocks, caches)):
            eps1, eps2 = m["ln_eps"][li]
            h = F.layer_norm(x, (H,), blk.ln1_w, blk.ln1_b, eps1)
            q, k, v = blk.qkv(h).view(B, s, 3, nh_l, hd).unbind(2)
            new_view, out = view.update_and_attend(q, k, v)
            new_caches.append(new_view)
            out = self._gather(out.reshape(B, s, nh_l * hd))   # heads
            x = x + self._gather(blk.proj(out))
            h2 = F.layer_norm(x, (H,), blk.ln2_w, blk.ln2_b, eps2)
            a = self._gather(F.gelu(blk.fc1(h2), approximate="tanh"))
            x = x + self._gather(blk.fc2(a))
        h = F.layer_norm(x, (H,), self.lnf_w, self.lnf_b, m["lnf_eps"])
        return self._gather(self.wte.attend(h)), new_caches


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def forward_tp(model: TPShardModel, ids, pools, tables, seq_lens,
               pos_offset, block_size, view_cls=PagedKVCache):
    """One forward over a rank's shards (the JAX ``forward_tp``):
    ``pools`` are the rank's per-layer ``(k, v)`` shards, ``view_cls``
    the cache semantics (``PagedKVCache``: decode and from-empty
    prefill; ``PagedChunkKernelView``: chunks and prefix hits;
    ``PagedVerifyKernelView``: the spec verify).  Returns ``(logits [B,
    s, V], new views)``; the pools change in place."""
    views = [view_cls.from_parts(k, v, tables, seq_lens, block_size)
             for k, v in pools]
    return model.forward_with_cache(ids, views, pos_offset)


def resolve_tp_devices(device: torch.device, tp: int, tp_devices=None,
                       n_cards: Optional[int] = None) -> List[torch.device]:
    """Each rank's device; rank 0's is the engine's.  Named devices win
    (``["cuda:0", "cuda:0"]`` puts two ranks on one card); otherwise CPU
    ranks for a CPU engine, and one card a rank on the card, raising when
    the machine has fewer cards than ranks (the JAX engine's check)."""
    if tp_devices is not None:
        devs = [torch.device(d) for d in tp_devices]
        if len(devs) != tp:
            raise ValueError(f"tp_degree={tp} needs {tp} devices; "
                             f"tp_devices names {len(devs)}")
        if devs[0].type != device.type or (
                device.index is not None and devs[0] != device):
            raise ValueError(f"rank 0 runs on the engine's device {device}, "
                             f"not {devs[0]}")
        return devs
    if device.type == "cpu":
        return [device] * tp
    n = torch.cuda.device_count() if n_cards is None else int(n_cards)
    if n < tp:
        raise ValueError(
            f"tp_degree={tp} needs {tp} local devices; the machine has {n} "
            "cards (name the ranks' devices with tp_devices= to share one)")
    first = device.index or 0
    return [torch.device("cuda", (first + r) % n) for r in range(tp)]


class TPProgram(graphs.Program):
    """A program of a tensor-parallel engine on rank 0: each run first
    sends its key and inputs to the worker ranks (:meth:`TPWorld.announce`),
    which run the same function on their shards; a warm-up run is
    announced as uncounted.  The engine never captures one (a gloo
    collective cannot be captured)."""

    def __init__(self, world: "TPWorld", key, fn, inputs, outputs,
                 inert=None):
        super().__init__(fn, inputs, outputs, inert)
        self.world = world
        self.key = key
        self._counted = True

    def _run(self) -> None:
        self.world.announce(self.key, self.inputs, self._counted)
        super()._run()

    def warm(self) -> None:
        self._counted = False
        try:
            super().warm()
        finally:
            self._counted = True


def _counter_snapshot() -> dict:
    return {f"{fn.__name__}.{attr}": v
            for fn, attr, v in graphs.snapshot()}


class TPWorld:
    """Rank 0's handle on the worker ranks: starts them
    (``python -m paddle_tpu_torch.inference.tp_worker``: a fresh
    interpreter a rank, which imports the port and nothing of the
    engine's process; its output in a temporary file), hands each its
    shards,
    announces every program run, collects reports, and stops them.  A
    worker that died raises :class:`TPWorkerError` at the next call (with
    its exit code and the tail of its output); a collective that fails
    because a peer died raises it too.  ``timeout_s`` bounds every
    collective of the group."""

    def __init__(self, tp: int, devices: List[torch.device],
                 backend: str = "gloo", timeout_s: float = 120.0):
        import torch.distributed as dist
        self.tp = int(tp)
        self.devices = list(devices)
        self.backend = backend
        self.timeout_s = float(timeout_s)
        self.closed = False
        self.procs = []
        self.logs: List[str] = []
        self.group = None
        self.store = dist.TCPStore("127.0.0.1", 0, None, True,
                                   timedelta(seconds=self.timeout_s),
                                   wait_for_workers=False)
        import paddle_tpu_torch
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(paddle_tpu_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        try:
            for r in range(1, self.tp):
                fd, path = tempfile.mkstemp(prefix=f"ptt_tp_rank{r}_",
                                            suffix=".log")
                self.logs.append(path)
                args = [str(a) for a in (
                    r, self.tp, self.store.port, self.devices[r], backend,
                    self.timeout_s)]
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "paddle_tpu_torch.inference.tp_worker", *args],
                    env=env, stdout=fd, stderr=subprocess.STDOUT))
                os.close(fd)
            self._wait_ready()
            self.group = _coll.private_group(self.store, 0, self.tp,
                                             backend, self.timeout_s)
        except BaseException:
            self.close()
            raise

    def _wait_ready(self) -> None:
        """Every worker has started and reached its process group (or one
        died: raise)."""
        end = time.monotonic() + self.timeout_s
        keys = [f"ready/{r}" for r in range(1, self.tp)]
        while not self.store.check(keys):
            self.check()
            if time.monotonic() > end:
                raise TPWorkerError(f"worker ranks not up in "
                                    f"{self.timeout_s:.0f} s")
            time.sleep(0.02)

    def _tail(self, r: int) -> str:
        try:
            with open(self.logs[r - 1], "rb") as f:
                return f.read().decode(errors="replace")[-2000:]
        except OSError:
            return ""

    def check(self) -> None:
        """Raise :class:`TPWorkerError` if a worker has exited."""
        for r, p in enumerate(self.procs, start=1):
            code = p.poll()
            if code is not None:
                raise TPWorkerError(
                    f"tensor-parallel rank {r} exited with code {code}:\n"
                    f"{self._tail(r)}")

    def failed(self, exc: BaseException) -> None:
        """A collective raised: name the dead worker if there is one
        (give it a moment to be reaped)."""
        end = time.monotonic() + 2.0
        while time.monotonic() < end:
            self.check()
            time.sleep(0.02)
        raise TPWorkerError(f"a tensor-parallel collective failed: "
                            f"{exc}") from exc

    def _bcast(self, msg) -> list:
        if self.closed:
            raise TPWorkerError("the tensor-parallel ranks were stopped")
        self.check()
        box = [msg]
        try:
            _coll.broadcast_object_list(box, 0, self.group)
        except RuntimeError as e:
            self.failed(e)
        return box

    def setup(self, config: dict, shards: Dict[int, Dict[str, Any]],
              draft_state: Optional[Dict[str, torch.Tensor]]) -> None:
        """Send the workers their configuration, each its shards (point
        to point), and the draft model's state (broadcast)."""
        flat = {r: flat_shards(s) for r, s in shards.items()}
        names = list(flat[1]) if self.tp > 1 else []
        config = dict(config, shard_specs=[
            (n, tuple(flat[1][n].shape), flat[1][n].dtype) for n in names],
            draft_specs=None if draft_state is None else [
                (n, tuple(t.shape), t.dtype) for n, t in draft_state.items()])
        self._bcast(("setup", config))
        try:
            for r in range(1, self.tp):
                for n in names:
                    _coll.send(flat[r][n].contiguous(), r, self.group)
            for t in (draft_state or {}).values():
                _coll.broadcast(t.contiguous(), 0, self.group)
        except RuntimeError as e:
            self.failed(e)

    def announce(self, key, inputs: dict, counted: bool = True) -> None:
        arrays = {n: t.detach().cpu().numpy() for n, t in inputs.items()}
        self._bcast(("run", key, arrays, bool(counted)))

    def report(self, local: dict) -> List[dict]:
        """Every rank's report (rank 0's is ``local``): its kernel
        counters, resident bytes, collective counts."""
        self._bcast(("report",))
        out: list = []
        try:
            _coll.all_gather_object(out, local, self.group)
        except RuntimeError as e:
            self.failed(e)
        return out

    def reset_counters(self) -> None:
        self._bcast(("reset",))

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the workers (politely, then by force) and reap them."""
        if self.closed:
            return
        self.closed = True
        alive = [p for p in self.procs if p.poll() is None]
        if alive and self.group is not None:
            try:
                _coll.broadcast_object_list([("stop",)], 0, self.group)
            except Exception:   # noqa: BLE001 - a dead peer: force below
                pass
        end = time.monotonic() + timeout_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for path in self.logs:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.group = None
