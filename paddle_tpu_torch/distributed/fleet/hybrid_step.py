"""The hybrid-parallel train step (pp x dp x mp, Megatron SP, ZeRO) and the
fused ZeRO-3 step: counterpart of
``paddle_tpu/distributed/fleet/hybrid_step.py``.

The JAX package runs each step as ONE program under ``shard_map`` over a
``(pp, dp, mp)`` mesh and differentiates through it.  The port is
process-granular: every rank of the job (``fleet.init``'s topology, on
the JAX mesh's order: pp outermost, mp innermost) calls the step with its
own shard of the parameters and runs the same tick arithmetic:

- PP: the interleaved (vpp = 1: GPipe) tick loop of the JAX ``loss_fn``
  (``spmd_pipeline.run_schedule``, the pipelines' own loop); activations
  move one stage a tick with ``spmd_pipeline.ring_permute``
  (backward: the reverse permute); bubble ticks skip the compute.
- TP: Megatron's column / row parallel QKV and MLP with ``mp_layers``'
  ``copy_to_mp`` / ``reduce_from_mp``, the vocab-parallel embedding, and
  the vocab-parallel loss (``ParallelCrossEntropy``).
- SP: between the TP regions activations are sequence-sharded; entering
  one all-gathers, leaving one reduce-scatters
  (``utils.sequence_parallel_utils``).
- DP + ZeRO-1/2: each rank takes its ``B / dp`` rows; Adam updates this
  rank's ``1 / dp`` flat slice of every leaf (stage 1 all-reduces the
  gradient and slices, stage 2 reduce-scatters it), then all-gathers.
- remat: each stage under ``torch.utils.checkpoint`` (non-reentrant).

The gradient rule.  The JAX step sums each leaf's per-rank cotangent over
every axis the leaf is not split on.  Here the operators' backwards
already make a leaf's gradient whole where they can (``copy_to_mp``
all-reduces, an all-gather reduce-scatters), so the step adds only the
sums they leave out: over pp for the leaves no stage splits (``wte``,
``wpe``, ``lnf_*``, ``head``: the first or last stage alone touches
them), and, with SP, over mp for the leaves the mp ranks hold alike (the
LayerNorms, ``bproj``, ``bfc2``, ``wpe``, ``lnf_*``: each rank saw its
own sequence slice).  The yardstick is :func:`serial_train_step`.

Parameters keep the JAX package's layout (``x @ W``, ``[in, out]``; wqkv's
output laid out ``[nh, 3, hd]``), so ``models/convert.py``'s
``hybrid_params_from_numpy`` carries a JAX tree over as it is.  A rank
holds :func:`hybrid_local_params` of the stacked tree: its stage's block
leaves ``[vpp, Lc, ...]`` (its mp slice), and ``wte`` / ``head`` sliced
over mp.  Attention is the port's ``flash_attention`` (causal): on the
card the ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` kernels,
on the CPU their plain versions.  The ZeRO-3 shard update runs on
``fused_adamw`` (its plain version on the CPU).

Context parallelism (``cp``) is ROADMAP.md A.8.4, expert parallelism
(``moe_num_experts``) A.8.5 and the checkpoints of both steps A.8.6: they
raise.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...observability import flight_recorder as _flight
from ...observability import metrics as _metrics
from ...observability import telemetry as _telemetry
from ...observability.flops import training_flops_per_token
from ...ops import flash_attention as _fa
from .. import collective as _coll
from .mp_layers import ParallelCrossEntropy, copy_to_mp, reduce_from_mp
from .sharding import flat_shard_layout, plan_zero3_buckets
from .spmd_pipeline import (_remat, join, run_schedule, schedule_ticks,
                            tick_work, tree_map)
from .utils import sequence_parallel_utils as _sp

__all__ = [
    "HybridConfig", "init_gpt_params", "stack_for_pipeline",
    "unstack_for_pipeline", "hybrid_param_specs", "hybrid_local_params",
    "gather_hybrid_params", "init_zero_state", "zero_state_specs",
    "make_hybrid_train_step",
    "make_zero3_train_step", "init_zero3_state", "zero3_unflatten",
    "save_zero3_state", "load_zero3_state",
    "save_hybrid_state", "load_hybrid_state",
    "serial_train_step", "serial_forward", "schedule_table",
    "bubble_fraction", "flatten", "unflatten", "tree_map",
]

# the JAX flags' defaults: zero3_bucket_mb, nan_watchdog_interval
ZERO3_BUCKET_MB = 16
NAN_WATCHDOG_INTERVAL = 1


@dataclass
class HybridConfig:
    vocab_size: int = 128
    hidden_size: int = 64
    num_layers: int = 4
    num_heads: int = 4
    seq_len: int = 32
    intermediate_size: int = 0
    # parallel degrees
    pp: int = 2
    mp: int = 2
    dp: int = 2
    vpp: int = 1  # virtual pipeline chunks per pp rank (interleaved)
    n_microbatches: int = 2
    sequence_parallel: bool = True
    cp: int = 1
    cp_attention: str = "ring"
    remat: bool = True
    moe_num_experts: int = 0
    moe_capacity: int = 0
    # ZeRO stage over dp: 1 all-reduces the gradients, 2 reduce-scatters
    # them, 3 is make_zero3_train_step's (make_hybrid_train_step treats
    # 3 as 2)
    zero_stage: int = 1
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.cp > 1:
            raise NotImplementedError(
                "HybridConfig.cp > 1 (context parallelism: ring / Ulysses "
                "attention) is not ported yet: see ROADMAP.md A.8.4")
        if self.moe_num_experts > 0:
            raise NotImplementedError(
                "HybridConfig.moe_num_experts > 0 (expert parallelism in "
                "the hybrid step) is not ported yet: see ROADMAP.md A.8.5")
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        assert self.num_layers % (self.pp * self.vpp) == 0
        assert self.num_heads % self.mp == 0
        assert self.hidden_size % self.num_heads == 0
        assert self.vocab_size % self.mp == 0
        if self.sequence_parallel:
            assert self.seq_len % self.mp == 0
        if self.vpp > 1:
            # whole blocks of pp micro-batches (Megatron's rule)
            assert self.n_microbatches % self.pp == 0
        assert self.cp_attention in ("ring", "ulysses")

    @property
    def layers_per_stage(self):
        """Layers per model CHUNK (a pp rank owns vpp chunks)."""
        return self.num_layers // (self.pp * self.vpp)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


# --------------------------------------------------------------------------
# trees: nested dicts, flattened in sorted-key order (jax.tree_util's)
# --------------------------------------------------------------------------

def flatten(tree):
    """``(leaves, treedef)`` in jax.tree_util's order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        leaves, defs = [], {}
        for k in sorted(tree):
            sub, d = flatten(tree[k])
            leaves.extend(sub)
            defs[k] = (d, len(sub))
        return leaves, defs
    return [tree], None


def unflatten(treedef, leaves):
    if treedef is None:
        return leaves[0]
    out, off = {}, 0
    for k in sorted(treedef):
        d, n = treedef[k]
        out[k] = unflatten(d, leaves[off:off + n])
        off += n
    return out


# --------------------------------------------------------------------------
# parameters: init (serial layout), pipeline stacking, specs, local shards
# --------------------------------------------------------------------------

def _param_shapes(cfg: HybridConfig):
    H, I, V, S, L = (cfg.hidden_size, cfg.intermediate_size,
                     cfg.vocab_size, cfg.seq_len, cfg.num_layers)
    blocks = {"ln1_g": (L, H), "ln1_b": (L, H), "wqkv": (L, H, 3 * H),
              "bqkv": (L, 3 * H), "wproj": (L, H, H), "bproj": (L, H),
              "ln2_g": (L, H), "ln2_b": (L, H), "wfc1": (L, H, I),
              "bfc1": (L, I), "wfc2": (L, I, H), "bfc2": (L, H)}
    return {"blocks": blocks, "wte": (V, H), "wpe": (S, H),
            "lnf_g": (H,), "lnf_b": (H,), "head": (H, V)}


def init_gpt_params(cfg: HybridConfig, generator=None, device="cpu"):
    """The serial GPT parameter tree (block leaves stacked ``[L, ...]``)
    on ``device``, drawn on the generator's device from ``generator`` (a
    ``torch.Generator``; a CPU one seeded 0 by default): normal weights
    with std 0.02 (the output projections 0.02 / sqrt(2 L)), LayerNorm
    gains one, biases zero, as the JAX ``init_gpt_params`` lays them
    out."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    std = 0.02
    shapes = _param_shapes(cfg)
    small = {"wproj", "wfc2"}

    def make(name, shape):
        if name.startswith("ln") and name.endswith("_g"):
            t = torch.ones(shape)
        elif name.startswith(("b", "ln")):
            t = torch.zeros(shape)
        else:
            scale = std / math.sqrt(2 * cfg.num_layers) if name in small \
                else std
            t = torch.randn(shape, generator=generator,
                            device=generator.device) * scale
        return t.to(device=device, dtype=cfg.dtype)
    out = {k: make(k, s) for k, s in shapes.items() if k != "blocks"}
    out["blocks"] = {k: make(k, s) for k, s in shapes["blocks"].items()}
    return out


def stack_for_pipeline(params: Dict[str, Any], cfg: HybridConfig):
    """Block leaves ``[L, ...]`` -> ``[pp, vpp, Lc, ...]``: global chunk g
    (layers ``[g Lc, (g + 1) Lc)``) lives on pp rank ``g % pp`` at chunk
    slot ``g // pp`` (the Megatron interleaved assignment)."""
    out = dict(params)
    lc = cfg.layers_per_stage

    def restack(v):
        w = v.reshape((cfg.vpp, cfg.pp, lc) + tuple(v.shape[1:]))
        return w.transpose(0, 1).contiguous()
    out["blocks"] = {k: restack(v) for k, v in params["blocks"].items()}
    return out


def unstack_for_pipeline(stacked: Dict[str, Any], cfg: HybridConfig):
    """The inverse of :func:`stack_for_pipeline`."""
    out = dict(stacked)
    out["blocks"] = {
        k: v.transpose(0, 1).reshape((cfg.num_layers,) + tuple(v.shape[3:]))
        for k, v in stacked["blocks"].items()}
    return out


def hybrid_param_specs(cfg: HybridConfig) -> Dict[str, Any]:
    """Per leaf of the stacked tree, the axis each dimension is split on
    (a tuple like the JAX ``PartitionSpec``; None: not split).  qkv and
    fc1 are column-parallel, proj and fc2 row-parallel, the embedding
    vocab-parallel, the head column-parallel over the vocabulary; block
    leaves ``[pp, vpp, Lc, ...]`` split on pp."""
    blocks = {
        "ln1_g": ("pp",), "ln1_b": ("pp",),
        "wqkv": ("pp", None, None, None, "mp"),
        "bqkv": ("pp", None, None, "mp"),
        "wproj": ("pp", None, None, "mp", None), "bproj": ("pp",),
        "ln2_g": ("pp",), "ln2_b": ("pp",),
        "wfc1": ("pp", None, None, None, "mp"),
        "bfc1": ("pp", None, None, "mp"),
        "wfc2": ("pp", None, None, "mp", None), "bfc2": ("pp",),
    }
    return {"blocks": blocks, "wte": ("mp", None), "wpe": (),
            "lnf_g": (), "lnf_b": (), "head": (None, "mp")}


def zero_state_specs(specs: Dict[str, Any]):
    """The optimizer state's specs: each leaf flattened and split over
    dp after the param's own axes."""
    leaves, treedef = flatten(specs)
    return unflatten(treedef, [tuple(a for a in s if a is not None)
                               + ("dp",) for s in leaves])


def hybrid_local_params(stacked, cfg: HybridConfig, pp_rank: int,
                        mp_rank: int):
    """This rank's shard of the stacked tree (what the JAX step sees
    inside ``shard_map``, the unit pp dimension of block leaves
    dropped)."""
    sizes = {"pp": cfg.pp, "mp": cfg.mp}
    ranks = {"pp": pp_rank, "mp": mp_rank}

    def local(leaf, spec):
        out, dim = leaf, 0
        for entry in spec:
            if entry == "pp":
                out = out[ranks["pp"]]
                continue
            if entry is not None:
                n = out.shape[dim] // sizes[entry]
                out = out.narrow(dim, ranks[entry] * n, n)
            dim += 1
        return out.contiguous()
    return tree_map(local, stacked, hybrid_param_specs(cfg))


def gather_hybrid_params(params_local, cfg: HybridConfig, hcg):
    """The stacked global tree from every rank's shard, on every rank
    (all-gathers over mp, then pp)."""
    mp_g = hcg.get_model_parallel_group()
    pp_g = hcg.get_pipe_parallel_group()

    def gather(leaf, spec):
        out = leaf.detach().contiguous()
        dims = [e for e in spec if e != "pp"]
        if "mp" in dims:
            out = _coll.all_gather_concat(out, dims.index("mp"), mp_g)
        if "pp" in spec:
            out = _coll.all_gather_concat(out[None].contiguous(), 0, pp_g)
        return out
    return tree_map(gather, params_local, hybrid_param_specs(cfg))


def init_zero_state(params_local, specs, dp: int):
    """Adam's (m, v) for this rank: per leaf a flat float zero slice of
    ``Fp / dp`` elements, ``Fp = dp * ceil(F / dp)`` with F the local
    leaf's size (the JAX ``init_zero_state``'s slices).  Returns
    ``(m, v, opt_specs)``."""
    leaves, treedef = flatten(params_local)
    m = [torch.zeros(flat_shard_layout(p.shape, dp)[1] // dp,
                     dtype=p.dtype, device=p.device) for p in leaves]
    return (unflatten(treedef, m),
            unflatten(treedef, [x.clone() for x in m]),
            zero_state_specs(specs))


# --------------------------------------------------------------------------
# model math (shared by the serial and the hybrid paths)
# --------------------------------------------------------------------------

def _layer_norm(x, g, b, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _attention(q, k, v):
    """Causal attention, ``[B, S, nh, hd]``: the port's flash attention
    (a head dim no kernel takes goes to the plain version on the card,
    counted in ``plain_calls``)."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    if _fa.plain_route(q):
        _fa.flash_attention_fwd.plain_calls += 1
        return _fa.flash_attention_fwd_reference(q, k, v, True)[0]
    return _fa.flash_attention(q, k, v, True)


def _block(p, x, lidx, nh_local, *, mp_group=None, seq_parallel=False):
    """One pre-LN transformer block; serial without ``mp_group``.  With
    ``seq_parallel`` x enters and leaves sequence-sharded ``[B, S/mp,
    H]``: the TP regions see the whole sequence through an all-gather in
    and a reduce-scatter out."""
    def take(name):
        return p[name][lidx]

    def enter_tp(h):
        if seq_parallel:
            return _sp.all_gather(h, 1, mp_group)
        return copy_to_mp(h, mp_group)

    def leave_tp(h):
        if seq_parallel:
            return _sp.reduce_scatter(h, 1, mp_group)
        return reduce_from_mp(h, mp_group)

    B = x.shape[0]
    h = enter_tp(_layer_norm(x, take("ln1_g"), take("ln1_b")))
    S = h.shape[1]
    # wqkv's 3H output is laid out [nh, 3, hd], so an mp column shard is
    # whole heads
    qkv = (h @ take("wqkv") + take("bqkv")).reshape(B, S, nh_local, 3, -1)
    a = _attention(qkv[:, :, :, 0], qkv[:, :, :, 1],
                   qkv[:, :, :, 2]).reshape(B, S, -1)
    x = x + leave_tp(a @ take("wproj")) + take("bproj")
    h = enter_tp(_layer_norm(x, take("ln2_g"), take("ln2_b")))
    f = F.gelu(h @ take("wfc1") + take("bfc1"), approximate="tanh")
    return x + leave_tp(f @ take("wfc2")) + take("bfc2")


def _lm_loss(logits, labels, mp_group=None):
    """The causal-LM loss over logits ``[B, S, V(/mp)]``, the last
    position ignored.  Over mp ranks: ``ParallelCrossEntropy`` (the
    maximum, the sum of exponentials and the target logit reduced over
    the group; only ``[B, S]`` crosses it).  One rank: the same math,
    the maximum a constant of the gradient."""
    if mp_group is not None and mp_group.nranks > 1:
        nll = ParallelCrossEntropy(mp_group=mp_group)(logits, labels)
    else:
        x = logits.float()
        mx = x.amax(dim=-1, keepdim=True).detach()
        logz = mx.squeeze(-1) + torch.log(torch.exp(x - mx).sum(dim=-1))
        nll = logz - x.gather(-1, labels[..., None].long())[..., 0]
    S = nll.shape[1]
    mask = (torch.arange(S, device=nll.device) < S - 1).to(nll.dtype)
    return (nll * mask).sum() / mask.sum() / nll.shape[0]


# --------------------------------------------------------------------------
# the serial path
# --------------------------------------------------------------------------

def serial_forward(params, ids, cfg: HybridConfig):
    """ids ``[B, S]`` -> the mean causal-LM loss (labels: ids shifted
    left)."""
    S = ids.shape[1]
    x = params["wte"][ids] + params["wpe"][:S]
    for layer in range(cfg.num_layers):
        x = _block(params["blocks"], x, layer, cfg.num_heads)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return _lm_loss(x @ params["head"], torch.roll(ids, -1, dims=1))


def _adam_math(p, g, m, v, step, cfg: HybridConfig):
    """Adam with the bias corrections in float32 (the JAX formula)."""
    t = torch.as_tensor(step, dtype=torch.float32, device=p.device)
    m2 = cfg.beta1 * m + (1 - cfg.beta1) * g
    v2 = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g)
    mh = m2 / (1 - cfg.beta1 ** t)
    vh = v2 / (1 - cfg.beta2 ** t)
    return p - cfg.learning_rate * mh / (torch.sqrt(vh) + cfg.eps), m2, v2


def _requires_grad(tree):
    leaves, treedef = flatten(tree)
    leaves = [p.detach().requires_grad_() for p in leaves]
    return leaves, unflatten(treedef, leaves)


def serial_train_step(params, m, v, step, ids, cfg: HybridConfig):
    """One Adam step of the serial model; ids ``[M, B, S]`` (the
    pipeline's micro-batch grouping).  Returns ``(loss, params, m, v)``."""
    leaves, ps = _requires_grad(params)
    loss = torch.stack([serial_forward(ps, ids[i], cfg)
                        for i in range(cfg.n_microbatches)]).mean()
    grads = torch.autograd.grad(loss, leaves)
    treedef = flatten(params)[1]
    out = [_adam_math(p.detach(), g, mm, vv, step, cfg) for p, g, mm, vv in
           zip(leaves, grads, flatten(m)[0], flatten(v)[0])]
    return (loss.detach(),) + tuple(unflatten(treedef, [o[i] for o in out])
                                    for i in range(3))


# --------------------------------------------------------------------------
# the hybrid step
# --------------------------------------------------------------------------

def _resolve_hcg(hcg, pp=1, dp=1, mp=1):
    """``hcg``; a dict of degrees, or None (``fleet.init``'s topology if
    there is one, else these degrees), made into one."""
    from .fleet import _fleet_state
    from .topology import HybridCommunicateGroup
    if hcg is None:
        hcg = _fleet_state["hcg"]
    if hcg is None or isinstance(hcg, dict):
        d = hcg or {"pp": pp, "dp": dp, "mp": mp}
        hcg = HybridCommunicateGroup(dp_degree=d.get("dp", 1),
                                     mp_degree=d.get("mp", 1),
                                     pp_degree=d.get("pp", 1))
    got = (hcg.get_pipe_parallel_world_size(),
           hcg.get_data_parallel_world_size(),
           hcg.get_model_parallel_world_size())
    if got != (pp, dp, mp):
        raise ValueError(f"the topology's (pp, dp, mp) {got} differ from "
                         f"the config's {(pp, dp, mp)}")
    return hcg


def _timed(step, name, cfg, tokens_of):
    """The step inside the ``train.step_seconds`` histogram, the flight
    recorder's guard and a ``StepTimeline`` (the JAX wrapper): with the
    watchdog on, the loss is read on the host inside the bracket and
    checked."""
    hist = _metrics.histogram(
        "train.step_seconds",
        "host wall time of one train step (labels: mode); enqueue time "
        "on the card unless the step syncs (the watchdog's probe does)")
    n_params = (cfg.num_layers * (4 * cfg.hidden_size ** 2
                                  + 2 * cfg.hidden_size
                                  * cfg.intermediate_size)
                + 2 * cfg.vocab_size * cfg.hidden_size
                + cfg.seq_len * cfg.hidden_size)
    tl = _telemetry.StepTimeline(
        name="train", flops_per_token=training_flops_per_token(
            n_params, cfg.num_layers, cfg.hidden_size, cfg.seq_len))
    count = [0]

    def timed_step(*args):
        count[0] += 1
        if count[0] == 1 and args[0] is not None:
            p = flatten(args[0])[0][0]
            tl.configure(device_kind=torch.cuda.get_device_name(p.device)
                         if p.is_cuda else "cpu")
        probe = _flight.enabled() and \
            count[0] % max(NAN_WATCHDOG_INTERVAL, 1) == 0
        loss = None
        t0 = time.perf_counter()
        with _flight.guard(f"{name}.train_step"), \
                tl.step(tokens=tokens_of(args), mode=name) as st:
            out = step(*args)
            if probe:
                loss = float(out[0])
                st.annotate(loss=loss, synced=True)
        hist.observe(time.perf_counter() - t0, mode=name)
        if probe:
            _flight.check_finite(loss, site=f"{name}.train_step.loss",
                                 step=count[0])
        return out
    timed_step.timeline = tl
    return timed_step


def make_hybrid_train_step(hcg, cfg: HybridConfig):
    """The hybrid train step over the topology ``hcg`` (a
    ``HybridCommunicateGroup``, a dict of ``pp`` / ``dp`` / ``mp``
    degrees, or None: ``fleet.init``'s, else the config's degrees; in
    every case the config's degrees).

    Returns ``step(params, m, v, step_no, ids) -> (loss, params, m, v)``,
    called on every rank: ``params`` this rank's
    :func:`hybrid_local_params`, ``m`` / ``v`` its
    :func:`init_zero_state`, ``step_no`` the 1-based Adam step, ``ids``
    ``[M, B, S]`` the whole batch (a rank takes its dp block of rows, the
    JAX ``P(None, "dp", None)``).  The loss (summed over pp, averaged
    over dp) comes back on every rank; the parameters and moments are new
    tensors."""
    hcg = _resolve_hcg(hcg, cfg.pp, cfg.dp, cfg.mp)
    MP, DP, VPP = cfg.mp, cfg.dp, cfg.vpp
    M = cfg.n_microbatches
    pp_g = hcg.get_pipe_parallel_group()
    dp_g = hcg.get_data_parallel_group()
    mp_g = hcg.get_model_parallel_group() if MP > 1 else None
    dp_i, mp_i = hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()
    nh_local = cfg.num_heads // MP
    Vloc = cfg.vocab_size // MP
    sp = cfg.sequence_parallel and MP > 1
    spec_leaves = flatten(hybrid_param_specs(cfg))[0]

    def embed(ps, ids):             # [b, S] -> [b, S(/mp), H]
        loc = ids - mp_i * Vloc
        ok = (loc >= 0) & (loc < Vloc)
        e = torch.where(ok[..., None],
                        F.embedding(loc.clamp(0, Vloc - 1), ps["wte"]), 0.0)
        if sp:
            e = _sp.reduce_scatter(e, 1, mp_g)
            s = e.shape[1]
            return e + ps["wpe"][mp_i * s:(mp_i + 1) * s]
        return reduce_from_mp(e, mp_g) + ps["wpe"][:ids.shape[1]]

    def stage(chunk, h):
        for layer in range(cfg.layers_per_stage):
            h = _block(chunk, h, layer, nh_local, mp_group=mp_g,
                       seq_parallel=sp)
        return h

    stage_fn = _remat(stage) if cfg.remat else stage

    def head_loss(ps, h, labels):
        h = _layer_norm(h, ps["lnf_g"], ps["lnf_b"])
        h = _sp.all_gather(h, 1, mp_g) if sp else copy_to_mp(h, mp_g)
        return _lm_loss(h @ ps["head"], labels, mp_g)

    def loss_and_grads(ps, ids_local):
        """The tick loop of the JAX ``loss_fn`` (``run_schedule``): stage
        0's slot 0 embeds micro-batch m, the last stage's last slot adds
        its head loss; the ring delivers rank PP-1's slot-j output to rank
        0 when it starts slot j + 1."""
        b, S = ids_local.shape[1], ids_local.shape[2]
        labels_all = torch.roll(ids_local, -1, dims=2)
        losses = []
        carry = run_schedule(
            lambda v, h: stage_fn({k: leaf[v] for k, leaf in
                                   ps["blocks"].items()}, h),
            lambda m: embed(ps, ids_local[m]),
            lambda m, h: losses.append(head_loss(ps, h, labels_all[m])),
            torch.empty((b, S // MP if sp else S, cfg.hidden_size),
                        dtype=cfg.dtype, device=ids_local.device),
            M, VPP, pp_g)
        loss_acc = sum(losses, torch.zeros((), dtype=torch.float32,
                                           device=ids_local.device))
        # the dp mean's factor now, its sum with the update; every rank's
        # backward runs the ring's permutes, last tick first
        join(loss_acc / (M * DP), carry).backward()
        return loss_acc.detach() / M

    def step(params, m, v, step_no, ids):
        b = ids.shape[1] // DP
        ids_local = ids[:, dp_i * b:(dp_i + 1) * b].to(
            flatten(params)[0][0].device)
        leaves, ps = _requires_grad(params)
        loss = loss_and_grads(ps, ids_local).reshape(1)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        # the sums the operators leave out (the module's head)
        _sp.allreduce_sequence_parallel_grads(
            [g for g, s in zip(grads, spec_leaves) if "pp" not in s], pp_g)
        if sp:
            _sp.allreduce_sequence_parallel_grads(
                [g for g, s in zip(grads, spec_leaves) if "mp" not in s],
                mp_g)
        _coll.all_reduce(loss, _coll.ReduceOp.SUM, pp_g)
        _coll.all_reduce(loss, _coll.ReduceOp.AVG, dp_g)
        new_p, new_m, new_v = [], [], []
        with torch.no_grad():
            for p, g, mm, vv in zip(leaves, grads, flatten(m)[0],
                                    flatten(v)[0]):
                # ZeRO: Adam on this dp rank's 1/dp flat slice, then the
                # all-gather; stage 1 all-reduces the gradient and
                # slices, stage 2 (and 3) reduce-scatters it
                F_, k = p.numel(), mm.numel()
                flat_p = F.pad(p.detach().reshape(-1), (0, DP * k - F_))
                flat_g = F.pad(g.reshape(-1), (0, DP * k - F_))
                psh = flat_p[dp_i * k:(dp_i + 1) * k]
                if cfg.zero_stage >= 2:
                    gsh = torch.empty_like(psh)
                    _coll.reduce_scatter(gsh, flat_g, group=dp_g)
                else:
                    _coll.all_reduce(flat_g, _coll.ReduceOp.SUM, dp_g)
                    gsh = flat_g[dp_i * k:(dp_i + 1) * k]
                p2, m2, v2 = _adam_math(psh, gsh, mm, vv, step_no, cfg)
                full = _coll.all_gather_concat(p2.contiguous(), 0, dp_g)
                new_p.append(full[:F_].reshape(p.shape))
                new_m.append(m2)
                new_v.append(v2)
        treedef = flatten(params)[1]
        return (loss[0], unflatten(treedef, new_p), unflatten(treedef, new_m),
                unflatten(treedef, new_v))

    timed = _timed(step, "hybrid", cfg, lambda a: int(a[4].numel()))
    timed.hcg = hcg
    return timed


# --------------------------------------------------------------------------
# the fused ZeRO-3 step: stage-3 FSDP over dp
# --------------------------------------------------------------------------
#
# Parameters and Adam moments live in the flat layout: each serial leaf
# flattened to F elements, zero-padded to Fp = dp * ceil(F / dp)
# (``sharding.flat_shard_layout``), a rank holding its Fp / dp slice.  The
# step gathers whole parameters with one all-gather per bucket
# (``sharding.plan_zero3_buckets`` at the JAX flag's 16 MiB, split where
# the dtype changes), reduce-scatters the gradients back to the slices,
# and updates the slices in place with ``fused_adamw``.

def _zero3_metas(cfg: HybridConfig, dp: int):
    shapes, treedef = flatten(_param_shapes(cfg))
    return [(tuple(s), cfg.dtype) + flat_shard_layout(s, dp)
            for s in shapes], treedef


def init_zero3_state(params, dp: int, rank: int):
    """This rank's flat ZeRO-3 slices of the serial tree ``params`` and
    zero moments: ``(flat_params, m, v)``, every leaf ``[Fp / dp]``."""
    leaves, treedef = flatten(params)
    fp, fm, fv = [], [], []
    for p in leaves:
        F_, Fp = flat_shard_layout(p.shape, dp)
        k = Fp // dp
        flat = F.pad(p.detach().reshape(-1), (0, Fp - F_))
        fp.append(flat[rank * k:(rank + 1) * k].clone())
        fm.append(torch.zeros(k, dtype=p.dtype, device=p.device))
        fv.append(torch.zeros(k, dtype=p.dtype, device=p.device))
    return (unflatten(treedef, fp), unflatten(treedef, fm),
            unflatten(treedef, fv))


def zero3_unflatten(flat_params, cfg: HybridConfig):
    """Whole flat leaves ``[Fp]`` (the ranks' slices concatenated) -> the
    serial tree."""
    shapes, treedef = flatten(_param_shapes(cfg))
    leaves = flatten(flat_params)[0]
    return unflatten(treedef, [f[:math.prod(s)].reshape(s)
                               for f, s in zip(leaves, shapes)])


def make_zero3_train_step(hcg, cfg: HybridConfig, grain: int = 0):
    """The fused ZeRO-3 train step over the data-parallel group of
    ``hcg`` (a ``HybridCommunicateGroup``, the dp degree as an int, or
    None: ``fleet.init``'s, else ``cfg.dp``).

    ``step(flat_params, m, v, step_no, ids) -> (loss, flat_params, m,
    v)``: this rank's :func:`init_zero3_state` slices, updated IN PLACE
    (the JAX step donates them) and returned; ids ``[M, B, S]`` the
    whole batch (a rank takes its dp block of rows).

    grain=0: the bucket gathers sit inside the differentiated function,
    so the gradients reduce-scatter through the gather's adjoint.
    grain=G>0: the batch is all-gathered and every rank differentiates
    every group of ``B / G`` rows against the whole parameters, folding
    the groups' gradients in global group order before taking its slice:
    the arithmetic holds no trace of dp, so any dp gives the same bits
    (at dp-fold gradient work)."""
    from ...ops.fused_optimizer import FusedTable, fused_adamw
    if isinstance(hcg, int):
        hcg = {"dp": hcg}
    hcg = _resolve_hcg(hcg, 1, cfg.dp, 1)
    assert cfg.zero_stage == 3, "make_zero3_train_step is the stage-3 path"
    assert cfg.pp == 1 and cfg.mp == 1, \
        "fused ZeRO-3 is dp-only FSDP; mp/pp belong to make_hybrid_train_step"
    dp_g = hcg.get_data_parallel_group()
    dp, d_i = cfg.dp, hcg.get_data_parallel_rank()
    M = cfg.n_microbatches
    metas, treedef = _zero3_metas(cfg, dp)
    n_leaves = len(metas)
    raw = plan_zero3_buckets(
        [Fp * torch.empty((), dtype=dt).element_size()
         for (_, dt, _, Fp) in metas], ZERO3_BUCKET_MB)
    buckets = []          # split at dtype changes: a bucket concatenates
    for b in raw:
        cur = [b[0]]
        for i in b[1:]:
            if metas[i][1] == metas[cur[-1]][1]:
                cur.append(i)
            else:
                buckets.append(cur)
                cur = [i]
        buckets.append(cur)

    def gather_full(shards):
        """Per-leaf ``[Fp / dp]`` slices -> the serial tree; one
        all-gather ``[dp, Kb]`` per bucket (backward: reduce-scatter)."""
        full = [None] * n_leaves
        for b in buckets:
            conc = shards[b[0]] if len(b) == 1 else \
                torch.cat([shards[i] for i in b])
            g = _sp.all_gather(conc[None], 0, dp_g)
            off = 0
            for i in b:
                shape, _, F_, Fp = metas[i]
                k = Fp // dp
                full[i] = g[:, off:off + k].reshape(dp * k)[:F_] \
                    .reshape(shape)
                off += k
        return unflatten(treedef, full)

    table = {}

    def update(p_shards, g_shards, m_l, v_l, step_no):
        """``fused_adamw``'s Adam rule (no decay, clip or scaler) over
        the slices, its step counter set to ``step_no``."""
        key = tuple(t.data_ptr() for t in p_shards + m_l + v_l)
        if table.get("key") != key:
            dev = p_shards[0].device
            table.update(key=key, step=torch.zeros(1, dtype=torch.int32,
                                                   device=dev),
                         t=FusedTable(p_shards, [None] * n_leaves,
                                      [[m, v] for m, v in zip(m_l, v_l)],
                                      [0.0] * n_leaves, [1.0] * n_leaves,
                                      [False] * n_leaves))
        table["step"].fill_(int(step_no) - 1)   # the kernel adds one
        fused_adamw(table["t"], g_shards, cfg.learning_rate, table["step"],
                    rule="adam", beta1=cfg.beta1, beta2=cfg.beta2,
                    epsilon=cfg.eps)

    def step(fp, m, v, step_no, ids):
        p_shards, m_l, v_l = flatten(fp)[0], flatten(m)[0], flatten(v)[0]
        b = ids.shape[1] // dp
        ids = ids.to(p_shards[0].device)
        if grain == 0:
            ids_local = ids[:, d_i * b:(d_i + 1) * b]
            leaves = [p.detach().requires_grad_() for p in p_shards]
            ps = gather_full(leaves)
            loss = torch.stack([serial_forward(ps, ids_local[i], cfg)
                                for i in range(M)]).mean()
            (loss / dp).backward()
            g_shards = [p.grad for p in leaves]
            loss = loss.detach().reshape(1)
            _coll.all_reduce(loss, _coll.ReduceOp.AVG, dp_g)
            loss = loss[0]
        else:
            # the rows in global order: the ranks' blocks concatenated
            ids_all = _coll.all_gather_concat(
                ids[:, d_i * b:(d_i + 1) * b].contiguous(), 1, dp_g)
            B = ids_all.shape[1]
            assert B % grain == 0, \
                f"global batch {B} must divide by grain {grain}"
            R = B // grain
            with torch.no_grad():
                full = flatten(gather_full(p_shards))[0]
            loss, gacc = None, None
            for gi in range(grain):
                leaves = [p.detach().requires_grad_() for p in full]
                sub = ids_all[:, gi * R:(gi + 1) * R]
                ps = unflatten(treedef, leaves)
                lg = torch.stack([serial_forward(ps, sub[i], cfg)
                                  for i in range(M)]).mean()
                gg = torch.autograd.grad(lg, leaves)
                loss = lg.detach() if loss is None else loss + lg.detach()
                gacc = list(gg) if gacc is None else \
                    [a + c for a, c in zip(gacc, gg)]
            loss = loss / grain
            g_shards = []
            for (shape, dt, F_, Fp), a in zip(metas, gacc):
                k = Fp // dp
                flat = F.pad((a / grain).reshape(-1).to(dt), (0, Fp - F_))
                g_shards.append(flat[d_i * k:(d_i + 1) * k].contiguous())
        with torch.no_grad():
            update(p_shards, [g.contiguous() for g in g_shards], m_l, v_l,
                   step_no)
        return loss, fp, m, v

    timed = _timed(step, "zero3", cfg, lambda a: int(a[4].numel()))
    timed.buckets = [tuple(b) for b in buckets]
    timed.hcg = hcg
    return timed


# --------------------------------------------------------------------------
# saving and loading: ROADMAP.md A.8.6
# --------------------------------------------------------------------------

def _no_checkpoints(what):
    raise NotImplementedError(
        f"{what}: the distributed checkpoints (distributed/checkpoint/) "
        "are not ported yet: see ROADMAP.md A.8.6")


def save_hybrid_state(*args, **kwargs):
    _no_checkpoints("save_hybrid_state")


def load_hybrid_state(*args, **kwargs):
    _no_checkpoints("load_hybrid_state")


def save_zero3_state(*args, **kwargs):
    _no_checkpoints("save_zero3_state")


def load_zero3_state(*args, **kwargs):
    _no_checkpoints("load_zero3_state")


# --------------------------------------------------------------------------
# schedule accounting (no execution)
# --------------------------------------------------------------------------

def schedule_table(pp: int, vpp: int, n_microbatches: int):
    """Per-rank tick table of the interleaved schedule, from the tick
    loop's own arithmetic (``spmd_pipeline.tick_work``): ``[rank][tick]``
    entries None for a bubble tick, else ``(chunk_slot, microbatch)``."""
    M = n_microbatches
    assert M % pp == 0, f"n_microbatches {M} must divide by pp {pp}"
    table = []
    for p in range(pp):
        row = []
        for t in range(schedule_ticks(pp, vpp, M)):
            v, m, active = tick_work(t, p, pp, vpp, M)
            row.append((v, m) if active else None)
        table.append(row)
    return table


def bubble_fraction(pp: int, vpp: int, n_microbatches: int) -> float:
    """Bubble ticks over busy ticks, per rank ``(pp - 1) / (M vpp)``
    (every tick computes one chunk)."""
    table = schedule_table(pp, vpp, n_microbatches)
    bubble = sum(e is None for row in table for e in row)
    busy = sum(e is not None for row in table for e in row)
    for row in table:
        work = [e for e in row if e is not None]
        assert len(set(work)) == len(work) == n_microbatches * vpp
    return bubble / busy if busy else 0.0
