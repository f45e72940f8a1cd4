"""bf16 flash attention on the CPU: the rounding of the tensor-core kernels.

In bfloat16 the port's forward and dq kernels run on the tensor cores and
round p (forward) and ds (dq) to bf16 before their second product, as the
JAX package's Pallas kernels do (``pallas_flash.py`` casts p to v's type
and ds to k's).  The card tests (``tests/test_torch_cuda.py``) hold them
to the port's plain versions, which do not round, at atol 2e-2 for
outputs and atol 2e-2 + rtol 1e-2 for gradients.  Here the same bf16
inputs, made with numpy, go through the JAX kernels in interpret mode
(which round there) and through the port's wrappers with CPU tensors (the
plain versions): they agree within those same tolerances, so the card
tests' tolerances hold the reference's own rounding.

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


@pytest.mark.parametrize("entry", ["flash_fwd", "flash_bwd_dq"])
@pytest.mark.parametrize("hd", [32, 96, 512])
def test_bf16_launch_at_an_unsupported_head_dim_raises(monkeypatch, entry,
                                                       hd):
    def unreachable():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(_build, "library", unreachable)
    x = torch.empty(1, 64, 2, hd, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    fn = {"flash_fwd": tflash.flash_attention_fwd,
          "flash_bwd_dq": tflash.flash_attention_bwd_dq}[entry]
    args = (x, x, x, True) if entry == "flash_fwd" else \
        (x, x, x, x, lse, x, True)
    before = fn.launches
    with pytest.raises(ValueError, match="head dim"):
        fn(*args)
    assert fn.launches == before
