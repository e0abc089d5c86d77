"""The arithmetic of the port's tensor-core attention kernel, emulated on the CPU.

``mxnet_tpu_torch/csrc/flash_attention.cu`` runs both products of attention
on Hopper's tensor cores: f32 inputs as 3xTF32 (each operand split into a
TF32 ``hi`` and a TF32 ``lo``, and ``lo*hi + hi*lo + hi*hi`` accumulated in
f32), bf16 inputs as bf16 with P rounded to bf16 before ``P V``.  The kernel
itself runs only on the card (``chip_smoke.py`` holds it to its plain
version there).  These tests check the arithmetic, not the kernel: no
change to the CUDA source or its wrapper can make them fail.  They replay
its recurrence in plain PyTorch: 64-key
tiles, the running max in base 2 with log2(e) folded into the scale, the
rescaled f32 accumulator, and the operand rounding of each product
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, 10 mantissa
bits, which the kernel computes with the same two integer operations as
``tf32`` below).  They show why the design is what it is:

- 3xTF32 stays within ``attention_tol(float32)`` (2e-4) of the plain f32
  version and of the JAX package's ``reference_attention``;
- one TF32 product does not (o off by up to 1.2e-3 here, l by far more),
  so it would fail the gate;
- bf16 operands with P in bf16 stay within ``attention_tol(bfloat16)``
  (4e-2) of the plain version on the same bf16 inputs, and within
  ``ATTENTION_HALF_ROW_ULPS`` bf16 ulps of each row's scale, the tighter
  check that ``chip_smoke.py`` also holds the kernel's bf16 o to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas_attention import reference_attention as jax_reference

from mxnet_tpu_torch.kernels.library import ATTENTION_HALF_ROW_ULPS, attention_tol, row_ulps
from mxnet_tpu_torch.ops.attention import NEG_INF, plain_flash_attention_fwd

BLOCK_K = 64                 # keys of a tile in the kernel
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
SHAPES = [(2, 2, 1024, 64), (1, 2, 512, 128)]
CASES = [(shape, causal) for shape in SHAPES for causal in (True, False)]


def tf32(x):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (the sign bit is apart, so adding half an ulp to the
    bit pattern rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def mm_f32(a, b):
    """bf16 operands: their products are exact in f32."""
    return a @ b


def mm_bf16_p(p, v):
    """P rounded to bf16 before P V, as the kernel does for bf16 inputs."""
    return p.to(torch.bfloat16).float() @ v


def emulate(q, k, v, causal, qk_mm, pv_mm):
    """The kernel's recurrence over 64-key tiles, on f32 tensors: returns
    ``(o, m, l)`` with m in natural units."""
    s_len = q.shape[2]
    scale2 = np.float32(q.shape[-1] ** -0.5) * LOG2E
    m = torch.full(q.shape[:3], NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    rows = torch.arange(s_len)[:, None]
    for k0 in range(0, s_len, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        s = qk_mm(q, kt.transpose(-1, -2)) * float(scale2)
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(keys > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + pv_mm(p, vt)
        m = m_new
    o = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return o, torch.where(m == NEG_INF, m, m * float(LN2)), l


def _inputs(shape, seed, bf16=False):
    rng = np.random.RandomState(seed)
    out = [torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(3)]
    if bf16:   # bf16 values, held in f32 for the emulation
        out = [t.to(torch.bfloat16).float() for t in out]
    return out


def _close(got, want, dtype):
    rtol, atol = attention_tol(dtype)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_tf32_split_is_exact_to_22_bits():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32) * 10)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
    # ties go away from zero: 1 + 2**-11 lies halfway between two TF32 values
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("shape,causal", CASES)
def test_3xtf32_within_f32_tolerance(shape, causal):
    q, k, v = _inputs(shape, seed=shape[2] + shape[3] + causal)
    o, m, l = emulate(q, k, v, causal, mm_3xtf32, mm_3xtf32)
    want = plain_flash_attention_fwd(q, k, v, causal)
    for got, w in zip((o, m, l), want):
        _close(got, w, torch.float32)
    ref = jax_reference(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal)
    _close(o, torch.from_numpy(np.array(ref)), torch.float32)


@pytest.mark.parametrize("shape,causal", CASES)
def test_1xtf32_is_outside_f32_tolerance(shape, causal):
    """One TF32 product alone misses the gate: the reason for 3xTF32.  o
    misses it (by 1.1-6x here), and l, a sum of up to S rounded terms, by
    two orders of magnitude."""
    q, k, v = _inputs(shape, seed=shape[2] + shape[3] + causal)
    got = emulate(q, k, v, causal, mm_1xtf32, mm_1xtf32)
    want = plain_flash_attention_fwd(q, k, v, causal)
    rtol, atol = attention_tol(torch.float32)
    # how far past the gate: the largest |got - want| - rtol |want|, in atols
    excess = [((g - w).abs() - rtol * w.abs()).max().item() / atol
              for g, w in zip(got, want)]
    assert not torch.allclose(got[0], want[0], rtol=rtol, atol=atol)
    assert excess[0] > 1 and excess[2] > 10


@pytest.mark.parametrize("shape,causal", CASES)
def test_bf16_p_within_bf16_tolerance(shape, causal):
    q, k, v = _inputs(shape, seed=shape[2] + shape[3] + causal + 1, bf16=True)
    o, m, l = emulate(q, k, v, causal, mm_f32, mm_bf16_p)
    want = plain_flash_attention_fwd(*(t.to(torch.bfloat16) for t in (q, k, v)), causal)
    _close(o.to(torch.bfloat16).float(), want[0].float(), torch.bfloat16)
    assert row_ulps(o.to(torch.bfloat16), want[0]) <= ATTENTION_HALF_ROW_ULPS
    # m and l are f32 and only the bf16 rounding of P separates them
    _close(m, want[1], torch.float32)
    _close(l, want[2], torch.float32)


def test_row_ulps_catches_what_the_bf16_atol_lets_through():
    """At S = 1024 a typical |o| is about 0.05: o moved by 0.02 over the last
    64 rows passes the 4e-2 gate, and fails the row check many times over."""
    shape, causal = SHAPES[0], True
    q, k, v = _inputs(shape, seed=shape[2] + shape[3] + causal + 1, bf16=True)
    want = plain_flash_attention_fwd(*(t.to(torch.bfloat16) for t in (q, k, v)), causal)[0]
    moved = want.float()
    moved[..., -64:, :] += 0.02
    moved = moved.to(torch.bfloat16)
    rtol, atol = attention_tol(torch.bfloat16)
    assert torch.allclose(moved.float(), want.float(), rtol=rtol, atol=atol)
    assert row_ulps(moved, want) > 10 * ATTENTION_HALF_ROW_ULPS
    assert row_ulps(want, want) == 0.0
