"""Activation recompute in the port against the JAX package, on the CPU.

GPT (every ``recompute_interval``-th block, full or selective with
``dots_with_no_batch_dims_saveable``), Llama and BERT with
``use_recompute``: loss and every gradient against the JAX model with the
same weights (``models/convert.py``), atol 1e-4, and against the port's
own run without recompute, bit for bit.  With dropout the recomputed
forward replays the forward's draws of the model's generator: the same
gradients and the same generator position as without recompute.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertForMaskedLM as JaxMLM
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt3_tiny as jax_gpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.models.bert import BertForMaskedLM, bert_tiny
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.ops import flash_attention as fa

# the module (the package's `recompute` name is the function)
RC = importlib.import_module("paddle_tpu_torch.distributed.fleet.recompute")
POLICIES = [None, "dots_with_no_batch_dims_saveable"]


def _port(jm, cls, cfg):
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = cls(cfg, device="cpu", seed=1)
    tm.load_state_dict(state_from_numpy(state, tm))
    tm.train()
    return tm


def _jax_grads(jm):
    names = {id(p): n for n, p in jm.named_parameters()}
    return {names[id(p)]: np.asarray(p.grad._value)
            for p in jm.parameters() if p.grad is not None}


def _check_against_jax(jm, tm, jl, tl, atol=1e-4):
    np.testing.assert_allclose(tl.item(), float(jl.item()), atol=atol,
                               rtol=0)
    want = state_from_numpy(_jax_grads(jm), tm)
    got = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=atol,
                                   rtol=0, err_msg=name)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("interval", [1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_recompute_matches_jax(interval, policy):
    kw = dict(num_layers=3, use_recompute=True, recompute_interval=interval,
              recompute_policy=policy)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.train()
    tm = _port(jm, GPTForCausalLM, gpt3_tiny(**kw))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (2, 32))
    jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
    jl.backward()
    tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    _check_against_jax(jm, tm, jl, tl)
    # and bit for bit the port's run without recompute
    plain = GPTForCausalLM(gpt3_tiny(num_layers=3), device="cpu")
    plain.load_state_dict(tm.state_dict())
    pl = plain.compute_loss(torch.from_numpy(ids), torch.from_numpy(ids))
    pl.backward()
    assert pl.item() == tl.item()
    for n, g in _grads(plain).items():
        assert torch.equal(g, dict(tm.named_parameters())[n].grad), n


def test_llama_recompute_matches_jax():
    kw = dict(use_recompute=True, num_kv_heads=2)
    paddle.seed(2)
    jm = JaxLlama(jax_llama_tiny(**kw))
    jm.train()
    tm = _port(jm, LlamaForCausalLM, llama_tiny(**kw))
    ids = np.random.RandomState(3).randint(0, 1024, (2, 24))
    jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
    jl.backward()
    tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    _check_against_jax(jm, tm, jl, tl)


def test_bert_recompute_matches_jax():
    kw = dict(use_recompute=True, dropout=0.0)
    paddle.seed(4)
    jm = JaxMLM(jax_bert_tiny(**kw))
    jm.train()
    tm = _port(jm, BertForMaskedLM, bert_tiny(**kw))
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 1024, (2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, 12:] = 0
    labels = np.where(rng.uniform(size=(2, 20)) < 0.3, ids, -100)
    jl = jm.compute_loss(paddle.to_tensor(ids), paddle.to_tensor(labels),
                         -100, None, paddle.to_tensor(mask))
    jl.backward()
    tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels),
                         -100, None, torch.from_numpy(mask))
    tl.backward()
    _check_against_jax(jm, tm, jl, tl)


def _gpt_run(recompute_on, policy, dropout, hidden=256, moe=0):
    """Loss, gradients and the generator's state after one step of a GPT
    whose heads are 64 wide (the flash wrappers' autograd Function, with
    its dropout seed drawn from the model's generator)."""
    cfg = gpt3_tiny(hidden_size=hidden, use_recompute=recompute_on,
                    recompute_policy=policy if recompute_on else None,
                    dropout=dropout, moe_num_experts=moe)
    model = GPTForCausalLM(cfg, device="cpu", seed=7)
    ids = torch.from_numpy(np.random.RandomState(8).randint(0, 1024, (2, 32)))
    loss = model.compute_loss(ids, ids)
    loss.backward()
    return loss.item(), _grads(model), model.generator.get_state()


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_under_recompute_replays_the_forward_draws(policy):
    """Dropout 0.1 in the flash kernels' plain version and the elementwise
    dropouts: recompute gives the loss, every gradient and the generator
    position of the run without it, bit for bit; without the replay the
    recomputed masks are new draws and the gradients differ."""
    want = _gpt_run(False, None, 0.1)
    got = _gpt_run(True, policy, 0.1)
    assert got[0] == want[0]
    assert set(got[1]) == set(want[1])
    for n in want[1]:
        assert torch.equal(got[1][n], want[1][n]), n
    assert torch.equal(got[2], want[2])


def test_without_the_replay_the_recompute_draws_new_masks(monkeypatch):
    want = _gpt_run(False, None, 0.1)
    monkeypatch.setattr(RC, "_generators", lambda function: [])
    got = _gpt_run(True, None, 0.1)
    assert max((got[1][n] - want[1][n]).abs().max().item()
               for n in want[1]) > 1e-6
    assert not torch.equal(got[2], want[2])


@pytest.mark.parametrize("policy,per_layer", [(None, 2), (POLICIES[1], 2),
                                              ("off", 1)])
def test_flash_forward_runs_again_under_either_policy(monkeypatch, policy,
                                                      per_layer):
    """The flash forward is not an aten op: the selective policy cannot
    save it, so it runs again in the backward as under full recompute (two
    forwards a layer a step; one without recompute)."""
    calls = []
    real = fa.flash_attention_fwd

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    _gpt_run(policy != "off", None if policy == "off" else policy, 0.0)
    assert len(calls) == per_layer * gpt3_tiny().num_layers


def test_moe_blocks_run_without_checkpointing():
    """GPT-MoE under recompute: the MoE blocks run plain (their aux loss
    leaves as an attribute), the dense ones are checkpointed; loss and
    gradients equal the run without recompute."""
    want = _gpt_run(False, None, 0.0, moe=2)
    got = _gpt_run(True, None, 0.0, moe=2)
    assert got[0] == want[0]
    for n in want[1]:
        torch.testing.assert_close(got[1][n], want[1][n], atol=1e-6,
                                   rtol=0)


def test_recompute_policies_and_plain_callables():
    """A bare callable and every policy name the port maps; any other name
    raises with its own name."""
    lin = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.GELU(),
                              torch.nn.Linear(8, 8))
    x = torch.randn(3, 8, requires_grad=True)
    lin(x).sum().backward()
    want = x.grad.clone()
    for policy in [None] + sorted(RC.POLICIES):
        x.grad = None
        recompute(lambda t: lin(t), x, policy=policy).sum().backward()
        torch.testing.assert_close(x.grad, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="offload_dot_with_no_batch_dims"):
        recompute(lin, x, policy="offload_dot_with_no_batch_dims")
