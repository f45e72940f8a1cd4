"""bf16 flash attention on the CPU: the rounding of the tensor-core kernels.

In bfloat16 the port's three flash kernels run on the tensor cores and
round p (forward), ds (dq), and P_drop and dS (dk/dv) to bf16 before
their second product.  The forward and dq round as the JAX package's
Pallas kernels do (``pallas_flash.py`` casts p to v's type and ds to
k's); the JAX dk/dv kernel keeps p and ds in fp32 (``pallas_flash.py``
:455-472), which interpret mode does not round.  The card tests
(``tests/test_torch_cuda.py``) hold the kernels to the port's plain
versions, which do not round, at atol 2e-2 for outputs and atol 2e-2 +
rtol 1e-2 for gradients.  Here the same bf16 inputs, made with numpy, go
through the JAX kernels in interpret mode and through the port's wrappers
with CPU tensors (the plain versions): they agree within those same
tolerances.  For dk/dv a model of the card kernel's rounding, computed
here, stays within them of the JAX kernel too, so the card's tolerance
covers the rounding the reference does not do.

Also here: a bf16 launch at a head dim the kernels do not take raises
before the kernel library is reached, and counts no launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_flash as jflash
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tflash

TOL = dict(atol=2e-2, rtol=0.0)
GRAD_TOL = dict(atol=2e-2, rtol=1e-2)
# (B, Sq, Sk, nh, nkv, causal) at hd 64: one tile of the JAX kernels;
# Sq > Sk leaves rows that see no key
CASES = [(2, 64, 64, 4, 4, True), (1, 64, 128, 4, 2, True),
         (1, 96, 64, 2, 2, True), (2, 64, 96, 2, 1, False)]


def _bf16_case(B, Sq, Sk, nh, nkv, hd=64, seed=11):
    """bf16 inputs as JAX arrays and as torch tensors, from one numpy
    draw (the float32 values rounded to bf16 once, by torch)."""
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, nh, hd), (B, Sk, nkv, hd), (B, Sk, nkv, hd),
              (B, Sq, nh, hd)]
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(torch.bfloat16) for s in shapes]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts]
    return ts, js


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("B,Sq,Sk,nh,nkv,causal", CASES)
def test_bf16_forward_matches_the_rounding_pallas_kernel(B, Sq, Sk, nh, nkv,
                                                         causal):
    (q, k, v, _), (jq, jk, jv, _) = _bf16_case(B, Sq, Sk, nh, nkv)
    out_j, lse_j = jflash.flash_attention_fwd(jq, jk, jv, causal=causal,
                                              interpret=True)
    out_t, lse_t = tflash.flash_attention_fwd(q, k, v, causal=causal)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(), _f32(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), _f32(lse_j)[..., 0], **TOL)
    if causal and Sq > Sk:
        assert not out_t[:, :Sq - Sk].any()


@pytest.mark.parametrize("B,Sq,Sk,nh,nkv,causal", CASES)
def test_bf16_dq_matches_the_rounding_pallas_kernel(B, Sq, Sk, nh, nkv,
                                                    causal):
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16_case(B, Sq, Sk, nh, nkv)
    out_j, lse_j = jflash.flash_attention_fwd(jq, jk, jv, causal=causal,
                                              interpret=True)
    dq_j = jflash.flash_attention_bwd(jq, jk, jv, out_j, lse_j, jdo,
                                      causal=causal, interpret=True)[0]
    out = torch.from_numpy(_f32(out_j)).to(torch.bfloat16)
    lse = torch.from_numpy(_f32(lse_j)[..., 0].copy())
    dq_t = tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, causal)
    assert dq_t.dtype == torch.bfloat16 and dq_t.shape == q.shape
    np.testing.assert_allclose(dq_t.float().numpy(), _f32(dq_j), **GRAD_TOL)


def _jax_bwd(case):
    """The port's bf16 inputs, and the JAX kernels' forward and backward
    (interpret mode) on the same values."""
    B, Sq, Sk, nh, nkv, causal = case
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16_case(B, Sq, Sk, nh, nkv)
    out_j, lse_j = jflash.flash_attention_fwd(jq, jk, jv, causal=causal,
                                              interpret=True)
    grads_j = jflash.flash_attention_bwd(jq, jk, jv, out_j, lse_j, jdo,
                                         causal=causal, interpret=True)
    out = torch.from_numpy(_f32(out_j)).to(torch.bfloat16)
    lse = torch.from_numpy(_f32(lse_j)[..., 0].copy())
    return (q, k, v, out, lse, do), grads_j


@pytest.mark.parametrize("case", CASES)
def test_bf16_dkv_matches_the_pallas_kernel(case):
    (q, k, v, out, lse, do), (_, dk_j, dv_j) = _jax_bwd(case)
    dk_t, dv_t = tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do,
                                                case[-1])
    for got, want, x in ((dk_t, dk_j, k), (dv_t, dv_j, v)):
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **GRAD_TOL)


def _dkv_as_the_card_rounds(q, k, v, out, lse, do, causal):
    """dk, dv as flash_bwd_dkv_tc_kernel computes them: scores, dP and D
    in fp32, then P and dS rounded to bf16 before dV = P^T dO and dK =
    dS^T Q (fp32 sums, over the GQA group too), one bf16 rounding at the
    end."""
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    s, valid, _ = tflash._scores(q, k, causal, None)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof,
                      v.float().repeat_interleave(nh // nkv, dim=2))
    delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) / np.sqrt(hd)
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    rep = (B, Sk, nkv, nh // nkv, hd)
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, dof).reshape(rep).sum(3)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, q.float()).reshape(rep).sum(3)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


@pytest.mark.parametrize("case", CASES)
def test_bf16_dkv_rounding_of_the_card_kernel_stays_in_tolerance(case):
    (q, k, v, out, lse, do), (_, dk_j, dv_j) = _jax_bwd(case)
    dk_r, dv_r = _dkv_as_the_card_rounds(q, k, v, out, lse, do, case[-1])
    plain = tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, case[-1])
    for got, want, unrounded in ((dk_r, dk_j, plain[0]),
                                 (dv_r, dv_j, plain[1])):
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **GRAD_TOL)
        # the model does round: it is not the plain version again
        assert not torch.equal(got, unrounded)


@pytest.mark.parametrize("entry", ["flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"])
@pytest.mark.parametrize("hd", [32, 96, 512])
def test_bf16_launch_at_an_unsupported_head_dim_raises(monkeypatch, entry,
                                                       hd):
    def unreachable():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(_build, "library", unreachable)
    x = torch.empty(1, 64, 2, hd, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    fn = {"flash_fwd": tflash.flash_attention_fwd,
          "flash_bwd_dq": tflash.flash_attention_bwd_dq,
          "flash_bwd_dkv": tflash.flash_attention_bwd_dkv}[entry]
    args = (x, x, x, True) if entry == "flash_fwd" else \
        (x, x, x, x, lse, x, True)
    before = fn.launches
    with pytest.raises(ValueError, match="head dim"):
        fn(*args)
    assert fn.launches == before
