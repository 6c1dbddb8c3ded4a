"""The port's flash-attention Function against JAX's stock Pallas TPU kernel.

JAX's ``jax.experimental.pallas.ops.tpu.flash_attention`` runs on the CPU in
interpret mode (``force_tpu_interpret_mode``), at the smallest ``T`` its
default 128-row blocks take. The port's Function computes its plain versions
on CPU tensors; the kernels themselves are held against those plain versions
on the card (``tests/test_torch_cuda.py``). Inputs come from numpy with a
seed; all float32 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jflash

from curvlinops_tpu_torch.models import flash_attention as tfa
from tests.test_torch_helpers import assert_close

B, H, T, HD = 2, 2, 128, 16
SM_SCALE = 1.0 / np.sqrt(HD)
# float32 sums in another order than JAX's blocked kernel (measured 7e-7 abs
# on outputs and gradients of magnitude ~1-3)
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((B, H, T, HD)).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(jflash(q, k, v, causal=True, sm_scale=SM_SCALE) * do)

    with pltpu.force_tpu_interpret_mode():
        o = jflash(q, k, v, causal=True, sm_scale=SM_SCALE)
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    expected = {"o": o, "dq": grads[0], "dk": grads[1], "dv": grads[2]}

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ot = tfa.flash_attention(qt, kt, vt, causal=True, sm_scale=SM_SCALE)
    dq, dk, dv = torch.autograd.grad(ot, (qt, kt, vt), torch.from_numpy(do))
    actual = {"o": ot, "dq": dq, "dk": dk, "dv": dv}
    return {"q": q, "k": k, "v": v, "do": do, "expected": expected, "actual": actual}


@pytest.mark.parametrize("name", ["o", "dq", "dk", "dv"])
def test_function_matches_jax_flash(case, name):
    """Forward and ``jax.grad`` of JAX's flash kernel against the port's
    Function (its plain versions on the CPU)."""
    assert_close(case["actual"][name], case["expected"][name], RTOL, ATOL, name)


def _attention_f64(q, k, v, causal=True):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v), torch.logsumexp(s, -1)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_versions_match_autograd(causal):
    """``flash_attention_plain`` and the explicit backward formulas of
    ``flash_attention_bwd_plain`` against float64 autograd of a softmax, at
    a ragged ``T`` (the kernels take any ``T``)."""
    rng = np.random.default_rng(1)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal((1, 3, 50, 32))).requires_grad_() for _ in range(4)
    )
    scale = 1.0 / 32**0.5
    o_ref, lse_ref = _attention_f64(q, k, v, causal)
    grads_ref = torch.autograd.grad(o_ref, (q, k, v), do)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal, sm_scale=scale)
    grads = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=scale)
    assert_close(o, o_ref, 1e-12, 1e-12, "o")
    assert_close(lse, lse_ref, 1e-12, 1e-12, "lse")
    for name, g, g_ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert_close(g, g_ref, 1e-10, 1e-12, name)


def test_function_gradcheck_float64():
    """``gradcheck`` of the Function in float64 (the plain path on the CPU)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (
        torch.randn((1, 2, 9, 16), generator=gen, dtype=torch.float64).requires_grad_()
        for _ in range(3)
    )
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=True, sm_scale=0.25), (q, k, v)
    )


def test_vmap_rule_folds_into_batch():
    """``torch.func.vmap`` over the forward and over a backward (as the KFAC
    factor pass runs it for several grad-output vectors) goes through the
    Functions' vmap rules once each and equals a loop over the vectors."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((2, 2, 20, 16), generator=gen).requires_grad_() for _ in range(3))
    dos = torch.randn((5, 2, 2, 20, 16), generator=gen)
    calls = {"fwd": 0, "bwd": 0}
    rules = {"fwd": tfa._FlashAttention.vmap, "bwd": tfa._FlashAttentionBackward.vmap}

    def spy(kind):
        def rule(*args):
            calls[kind] += 1
            return rules[kind](*args)

        return staticmethod(rule)

    try:
        tfa._FlashAttention.vmap = spy("fwd")
        tfa._FlashAttentionBackward.vmap = spy("bwd")
        o = tfa.flash_attention(q, k, v, sm_scale=0.25)

        def vjp(do):
            return torch.autograd.grad(o, (q, k, v), do, retain_graph=True)

        batched = torch.func.vmap(vjp)(dos)
        qs = torch.stack([q.detach()] * 3)
        o_batched = torch.func.vmap(lambda q: tfa.flash_attention(q, k, v, sm_scale=0.25))(qs)
    finally:
        tfa._FlashAttention.vmap = staticmethod(rules["fwd"])
        tfa._FlashAttentionBackward.vmap = staticmethod(rules["bwd"])
    assert calls == {"fwd": 1, "bwd": 1}
    for i in range(dos.shape[0]):
        for g_b, g in zip(batched, vjp(dos[i])):
            assert_close(g_b[i], g, 1e-6, 1e-6, f"vector {i}")
    assert_close(o_batched[1], o, 1e-6, 1e-6, "vmapped forward")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, on the bits viewed as int32, as the kernels round ``hi``."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor core reads a TF32 operand: the low 13 bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _einsum_tf32(eq, a, b):
    """One TF32 product per float32 product (float32 sums)."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _einsum_3xtf32(eq, a, b):
    """The backward kernels' 3xTF32 product: ``a_hi = tf32(a)``, ``a_lo = a - a_hi``
    as the tensor core reads it, ``a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi``."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return sum(torch.einsum(eq, x, y) for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)))


def _bwd_with(einsum, q, k, v, do, lse, di, sm_scale):
    """The plain ``dkv``/``dq`` formulas (causal) with every product through ``einsum``."""
    s = einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - lse[..., None])
    ds = p * (einsum("bhqd,bhkd->bhqk", do, v) - di[..., None])
    dq = einsum("bhqk,bhkd->bhqd", ds, k) * sm_scale
    dk = einsum("bhqk,bhqd->bhkd", ds, q) * sm_scale
    dv = einsum("bhqk,bhqd->bhkd", p, do)
    return dq, dk, dv


@pytest.mark.parametrize("logits", ["unit", "large"])
def test_3xtf32_split_meets_the_float32_gate(logits):
    """Why the backward kernels split float32 operands for the TF32 tensor
    cores: with the 3xTF32 split on every product (``q``, ``k``, ``v``,
    ``dO``, ``P`` and ``dS``), ``dq``, ``dk`` and ``dv`` agree with the float32
    plain version within 1e-5 relative Frobenius error, ten times inside the
    card's 1e-4 gate; one TF32 pass does not. "large" scales q by 4 and k by 2
    (scores of standard deviation 8), as the card test of large logits does."""
    rng = np.random.default_rng(3)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal((1, 2, 256, 64)).astype(np.float32)) for _ in range(4)
    )
    if logits == "large":
        q, k = 4 * q, 2 * k
    o, lse = tfa.flash_attention_plain(q, k, v, causal=True, sm_scale=0.125)
    di = (o * do).sum(-1)
    refs = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, sm_scale=0.125)
    split = _bwd_with(_einsum_3xtf32, q, k, v, do, lse, di, 0.125)
    one_pass = _bwd_with(_einsum_tf32, q, k, v, do, lse, di, 0.125)
    for name, a, b, c in zip(("dq", "dk", "dv"), split, one_pass, refs):
        assert float((a - c).norm() / c.norm()) < 1e-5, name
        assert float((b - c).norm() / c.norm()) > 1e-5, name


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors nothing is launched: the counters stay put."""
    before = dict(tfa.launches)
    q = torch.randn((1, 1, 8, 16), requires_grad=True)
    tfa.flash_attention(q, q, q, sm_scale=0.25).sum().backward()
    assert tfa.launches == before and set(before) == {"fwd", "bwd_dkv", "bwd_dq"}
