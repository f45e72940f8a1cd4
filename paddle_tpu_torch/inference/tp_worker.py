"""A worker rank of a tensor-parallel serving engine.

``python -m paddle_tpu_torch.inference.tp_worker RANK SIZE PORT DEVICE
BACKEND TIMEOUT``, started by ``tp.TPWorld`` (its output goes to a file
the engine reads when the rank fails).  It joins
the group, takes its configuration (broadcast), its shards (point to
point) and a draft model's state (broadcast), builds its
``TPShardModel``, pools and programs, then runs what rank 0 announces
until told to stop: ``("run", key, inputs, counted)`` runs the program
``key`` on those inputs (an uncounted run restores the kernel counters
after it, as a warm-up does on rank 0), ``("report",)`` all-gathers this
rank's counters and resident bytes, ``("reset",)`` zeroes its counters.
Any failure ends the process with a traceback on its output and a nonzero
code, which rank 0 sees as a failed collective or a dead rank.

The chaos site ``tp.worker.run`` fires before a run when
``PTT_CHAOS_TP_WORKER`` names the 1-based runs to fail (comma list): the
way tests make a worker raise.
"""

from __future__ import annotations

import os
import sys

import torch


def _recv_tree(specs, src, group, device):
    from ..distributed import collective as coll
    out = {}
    for name, shape, dtype in specs:
        t = torch.empty(shape, dtype=dtype)
        coll.recv(t, src, group)
        out[name] = t.to(device)
    return out


def _bcast_tree(specs, group, device):
    from ..distributed import collective as coll
    out = {}
    for name, shape, dtype in specs:
        t = torch.empty(shape, dtype=dtype, device=device)
        coll.broadcast(t, 0, group)
        out[name] = t
    return out


def run(rank: int, size: int, port: int, device: str, backend: str,
        timeout: float) -> int:
    from datetime import timedelta

    import torch.distributed as dist

    from ..distributed import collective as coll
    from ..testing import chaos
    from . import graphs, tp
    from .serving import _program_parts, _pools_for

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", int(port), None, False,
                          timedelta(seconds=timeout))
    store.set(f"ready/{rank}", "1")
    group = coll.private_group(store, rank, size, backend, timeout)
    calls = [int(c) for c in
             os.environ.get("PTT_CHAOS_TP_WORKER", "").split(",") if c]
    # held for the process's life: a collected context would disarm it
    armed = chaos.fail_at("tp.worker.run", on_calls=calls, exc=RuntimeError)
    if calls:
        armed.__enter__()

    box = [None]
    coll.broadcast_object_list(box, 0, group)
    _, cfg = box[0]
    shards = tp.unflat_shards(_recv_tree(cfg["shard_specs"], 0, group,
                                         "cpu"))
    model = tp.TPShardModel(cfg["meta"], shards, group, rank, device)
    del shards
    draft = None
    if cfg["draft_specs"] is not None:
        from ..models.gpt import GPTForCausalLM
        from .quant import quantize_model
        state = _bcast_tree(cfg["draft_specs"], group, device)
        draft = GPTForCausalLM(cfg["draft_cfg"], device=device,
                               dtype=cfg["draft_dtype"])
        draft.load_state_dict(state, strict=True)
        draft.eval()
        if cfg["quant"]:
            draft, _ = quantize_model(draft, cfg["quant"])
    if device.type == "cuda":
        from ..ops import _build
        _build.library()
    pools = _pools_for(model, cfg["num_blocks"], cfg["bs"], device)
    dpools = _pools_for(draft, cfg["num_blocks"], cfg["bs"], device) \
        if draft is not None else None
    programs = {}
    while True:
        box = [None]
        coll.broadcast_object_list(box, 0, group)
        msg = box[0]
        if msg[0] == "stop":
            break
        if msg[0] == "reset":
            graphs.restore([(fn, a, 0) for fn, a in graphs.counters()])
            model.comm_calls = model.comm_bytes = 0
            model.comm_s = 0.0
            continue
        if msg[0] == "report":
            out = []
            coll.all_gather_object(out, _report(model, pools, dpools),
                                   group)
            continue
        _, key, arrays, counted = msg
        chaos.inject("tp.worker.run")
        prog = programs.get(key)
        if prog is None:
            fn, ins, outs, inert = _program_parts(
                key, model, pools, draft, dpools, cfg["bs"], cfg["B"],
                cfg["nb"], device)
            prog = programs[key] = graphs.Program(fn, ins, outs, inert)
        for n, a in arrays.items():
            prog.inputs[n].copy_(torch.from_numpy(a))
        snap = None if counted else graphs.snapshot()
        prog._run()
        if snap is not None:
            graphs.restore(snap)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return 0


def _report(model, pools, dpools) -> dict:
    from . import tp
    pool_bytes = sum(t.numel() * t.element_size()
                     for kv in pools for t in kv)
    out = {"counters": tp._counter_snapshot(),
           "weight_bytes": model.resident_bytes(),
           "pool_bytes": pool_bytes, "pool_heads": pools[0][0].shape[0],
           "comm_calls": model.comm_calls, "comm_bytes": model.comm_bytes,
           "comm_s": model.comm_s,
           "modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "paddle_tpu"))}
    if dpools is not None:
        out["draft_pool_bytes"] = sum(t.numel() * t.element_size()
                                      for kv in dpools for t in kv)
    return out


if __name__ == "__main__":
    rank, size, port, device, backend, timeout = sys.argv[1:7]
    sys.exit(run(int(rank), int(size), int(port), device, backend,
                 float(timeout)))
