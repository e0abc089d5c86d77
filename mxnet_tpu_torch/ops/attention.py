"""Blockwise (flash) attention: the CUDA kernel's wrapper, its plain
version, and the autograd Function around it.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py``.  The kernel,
``mxnet_tpu_torch/csrc/flash_attention.cu``, replaces the TPU kernel
``pallas_attention.py:_attn_kernel``: for ``(B, H, S, D)`` q, k and v,
``softmax(sm_scale * q k^T) v`` by the online-softmax recurrence,
optionally causal, with the running max ``m`` and sum ``l`` of every row
as ``(B, H, S)`` f32.  Masked scores are ``-1e30`` (``_NEG_INF``); a row
with ``l == 0`` gives 0.

Type policy: q, k and v are f32 or bf16 (all three alike), and both
products run on the tensor cores.  f32 runs as 3xTF32: each operand is
split into two TF32 parts, and ``lo*hi + hi*lo + hi*hi`` is accumulated in
f32, a few 1e-6 from plain f32 (one TF32 product alone misses the 2e-4
gate; ``tests/test_torch_attention_numerics.py`` shows both).  bf16 goes to
the tensor cores as bf16 with P rounded to bf16 for ``P V``, as
FlashAttention does.  The running max, the sum, the accumulator and the
rescaling stay f32, and ``o`` is written in the input dtype, as the TPU
kernel does.

What bounds it on the card: operations.  At the slice's
``(8, 12, 1024, 64)`` causal it needs about 12.9 GFLOP against 0.1 GB of
inputs and outputs.  The design keeps the S x S scores in registers: one
block of four warps per (b*h, ``_BLOCK_Q``-row q tile), 16 q rows a warp,
``mma.sync`` for both products, a loop over 64-key tiles whose next k and
v tiles are copied by ``cp.async`` into a second stage of shared memory
while the current ones compute, P kept in registers as the A operand of
``P V``, and causal k tiles above the diagonal skipped.  Views whose rows
do not start on 16 bytes are staged with scalar loads by the same kernel.
Head dims up to ``MAX_HEAD_DIM`` are zero-padded to 32, 64 or 128.

The backward recomputes through ``reference_attention`` under autograd, as
``_flash_bwd_rule`` does through ``_reference_attention``: the JAX package
has no backward kernel.

A wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from ..kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_BLOCK_Q = 64          # q rows per block of the kernel, 16 per warp (csrc/flash_attention.cu)
_MAX_GRID_Y = 65535
_ENTRY = {torch.float32: "flash_attn_forward_f32",
          torch.bfloat16: "flash_attn_forward_bf16"}
_FNS = {}


def _kernel_fn(dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(build.load("flash_attention"), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def static_sm_scale(sm_scale, head_dim):
    """The softmax scale as a Python float: ``head_dim ** -0.5`` when None;
    a tensor raises TypeError, as ``_static_sm_scale`` does for a traced
    value (the scale is a kernel argument, not data)."""
    if sm_scale is None:
        return head_dim ** -0.5
    if not isinstance(sm_scale, (int, float)):
        raise TypeError("flash_attention: sm_scale must be a Python scalar "
                        f"(got {type(sm_scale).__name__})")
    return float(sm_scale)


def _check(q, k, v):
    if q.dim() != 4:
        raise MXNetError(f"flash_attention takes (B, H, S, D) q, got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must have one shape")
    if k.device != q.device or v.device != q.device:
        raise MXNetError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"q {q.dtype}, k {k.dtype} and v {v.dtype} must have one dtype")


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """``(o (B, H, S, D) q.dtype, m (B, H, S) f32, l (B, H, S) f32)``.

    On a CUDA tensor this launches ``csrc/flash_attention.cu`` on the
    current stream and counts the launch in
    ``flash_attention_fwd.launches``.  q, k and v are f32 or bf16 and may
    be strided views with stride 1 over the head dim (a head split by
    ``transpose`` needs no copy); D is at most ``MAX_HEAD_DIM``.  On a CPU
    tensor it returns ``plain_flash_attention_fwd``.
    """
    _check(q, k, v)
    scale = static_sm_scale(sm_scale, q.shape[-1])
    if q.device.type == "cpu":
        return plain_flash_attention_fwd(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention has no kernel for device {q.device}")
    if q.dtype not in _ENTRY:
        raise MXNetError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if -(-s // _BLOCK_Q) > _MAX_GRID_Y or b * h >= 2 ** 31:
        raise MXNetError(f"flash_attention kernel: shape {tuple(q.shape)} is too large")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise MXNetError("flash_attention kernel takes q, k, v with stride 1 over "
                         "the head dim")
    o = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, m, l
    strides = (ctypes.c_int64 * 9)(*(st for t in (q, k, v) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), m.data_ptr(), l.data_ptr(),
                                  b, h, s, d, ctypes.addressof(strides), scale,
                                  int(bool(causal)), stream)
    if err != 0:
        raise MXNetError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, m, l


flash_attention_fwd.launches = 0


def _causal_mask(s, device):
    idx = torch.arange(s, device=device)
    return idx[None, :] <= idx[:, None]


def plain_flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """The kernel's plain version: the same ``(o, m, l)`` from the whole
    score matrix, in f32 inside."""
    scale = static_sm_scale(sm_scale, q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = logits.masked_fill(~_causal_mask(q.shape[2], q.device), NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p, v.float()) / safe_l[..., None]
    return o.to(q.dtype), m, l


def reference_attention(q, k, v, causal=False, sm_scale=None):
    """Plain attention with ``flash_attention``'s signature, f32 inside and
    the input dtype out (counterpart of ``reference_attention``)."""
    scale = static_sm_scale(sm_scale, q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = logits.masked_fill(~_causal_mask(q.shape[2], q.device), NEG_INF)
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Forward through ``flash_attention_fwd``; backward recomputes through
    ``reference_attention`` (counterpart of ``_flash_bwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, _m, _l = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = reference_attention(q, k, v, ctx.causal, ctx.sm_scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def _positive_int(value, name):
    if isinstance(value, bool) or not isinstance(value, int) or value <= 0:
        raise MXNetError(f"flash_attention: {name} must be a positive int, got {value!r}")


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=128, block_k=128):
    """``softmax(q k^T * sm_scale) v`` over ``(batch, heads, seq, head_dim)``,
    differentiable; ``sm_scale`` defaults to ``head_dim ** -0.5``.

    ``block_q`` and ``block_k`` are the JAX signature's tile sizes.  They are
    checked to be positive ints and otherwise unused: the CUDA kernel picks
    its own tiles (64 q rows x 64 keys), and the result does not depend on
    them, on either package.
    """
    _positive_int(block_q, "block_q")
    _positive_int(block_k, "block_k")
    return FlashAttention.apply(q, k, v, bool(causal), sm_scale)
