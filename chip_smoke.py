#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of the repository, on a machine with one CUDA device and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each: ``device``; ``build`` (nvcc for sm_90a, one
process per ``mxnet_tpu_torch/csrc/*.cu``, all at once, and the count of
tensor-core instructions in each library's SASS); ``kernel_check`` (each
kernel against its plain PyTorch version, forward and backward, at the
tolerance of its library entry, at its path's shape and layout and a few
others);
two paths, each driven with every kernel's launch count set to 0 just
before and read just after:

- ``slice``: 5 train steps of full-width ResNet-50 v1, batch 32, 224x224,
  fp32 (kernel: softmax_ce);
- ``slice_transformer``: one forward of the 12-layer pre-LN transformer
  stack at GPT-2 small's widths (embed 768, 12 heads, ffn 3072), batch 8 x
  1024 tokens, causal, fp32, under ``torch.no_grad()`` (kernels: layernorm,
  24 launches, and attention, 12);
- ``rtc_full_width``: full-width ResNet-50 v1's 193 trainable tensors,
  synthetic gradients and momentum buffers held as ``mx.nd`` NDArrays
  without a copy (``nd.from_dlpack``); one SGD-with-momentum kernel in CUDA
  C, compiled by ``mx.rtc`` (NVRTC), launched once per tensor and held to
  ``sgd_mom_update``; MXNet's doc ``axpy`` over one buffer of 25 575 912
  floats; then ``save_parameters`` of the net and ``load_parameters`` into
  a net from another seed, bit-equal (kernel: rtc, 194 launches);

``parity`` and ``parity_transformer`` (a narrow ResNet v1 train step, and a
2-layer stack's forward and gradients, on the card and on the CPU from the
same weights and inputs); ``rtc`` (the cases of ``tests/test_rtc.py`` in
CUDA C through ``mx.rtc``, a compile error and a 2048-thread launch that
must raise, with NVRTC's seconds per source); ``timing``,
``timing_transformer`` (attention in f32 and bf16) and ``timing_rtc`` (CUDA
events, warm-up excluded, and the profiler's device time, for the library
calls too).  Then one line ``{"kernels": [...]}``, the card's name
and power limit as nvidia-smi gives them, and last ``{"ok": true,
"device": {...}}``.

TF32 is off for every phase, the timed ones included: the numbers are
strict fp32.  Any failure raises, so the script exits non-zero and prints
no last line; it does the same when CUDA is not available.
"""
from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, IMAGE, STEPS = 32, 224, 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
NARROW = ([1, 1, 1, 1], [8, 32, 64, 128, 256], 10)
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5   # tests/test_torch_resnet.py
# GPT-2 small (Radford et al. 2019; the released gpt2 hparams): embed 768,
# 12 heads of 64, ffn 3072, 12 layers, context 1024; batch 8, causal
GPT2_SMALL = {"layers": 12, "embed": 768, "heads": 12, "ffn": 3072, "batch": 8,
              "seq": 1024}
NARROW_TF = {"layers": 2, "embed": 64, "heads": 4, "ffn": 256, "batch": 2, "seq": 100}
# card (cuBLAS, no TF32) against CPU: the same f32 products summed in other
# orders through two layers; the absolute floor scales with the largest
# magnitude of each tensor, since gradients of out.sum() reach ~1e2
PARITY_TF_TOL = 1e-4
# rtc kernels against their plain versions: NVRTC contracts a * b + c into
# one FMA by default (--fmad=true), where the plain PyTorch version rounds
# the product first, so results differ in the last bit or two
RTC_RTOL, RTC_ATOL = 1e-6, 1e-7
RESNET50_TRAINABLE = 25_575_912
SGD = {"lr": 0.01, "momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0}

# CUDA C compiled at run time by mx.rtc, as an MXNet user's would be.  The
# doc example of python/mxnet/rtc.py: no bounds check, so grid * block must
# be the size exactly.
AXPY_SRC = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
"""
AXPY_SIG = "const float *x, float *y, float alpha"
# MXNet's sgd_mom_update (mxnet_tpu/ops/_op_optimizer.py:45), grid-stride
SGD_MOM_SRC = r"""
extern "C" __global__ void sgd_mom(const float *grad, float *weight, float *mom,
                                   float lr, float momentum, float wd, float rescale,
                                   int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        float w = weight[i];
        float m = momentum * mom[i] - lr * (grad[i] * rescale + wd * w);
        mom[i] = m;
        weight[i] = w + m;
    }
}
"""
SGD_MOM_SIG = ("const float *grad, float *weight, float *mom, float lr, float momentum, "
               "float wd, float rescale, int n")
SGD_MOM_THREADS, SGD_MOM_MAX_BLOCKS = 256, 132 * 16
# the cases of tests/test_rtc.py in CUDA C
RTC_CASES_SRC = {
    "scale2": r"""
extern "C" __global__ void scale2(const float *x, float *a, float *b) {
    int i = threadIdx.x;
    a[i] = x[i] * 2.0f;
    b[i] = x[i] * 3.0f;
}
""",
    "rowscale": r"""
extern "C" __global__ void rowscale(const float *x, float *y, float alpha, int cols) {
    int row = blockIdx.x;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        y[row * cols + c] = x[row * cols + c] * alpha;
}
""",
    "addi": r"""
extern "C" __global__ void addi(const int *x, int *y, int k) {
    int i = threadIdx.x;
    y[i] = x[i] + k;
}
""",
    "scale_t": r"""
template <typename T>
__global__ void scale_t(const T *x, T *y, T alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] * alpha;
}
""",
    "smem_reverse": r"""
extern "C" __global__ void smem_reverse(const float *x, float *y, int n) {
    extern __shared__ float buf[];
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
}
""",
    "scalars": r"""
extern "C" __global__ void scalars(float *out, unsigned short h, unsigned short b,
                                   double d, signed char i8, unsigned char u8) {
    out[0] = h; out[1] = b; out[2] = (float)d; out[3] = i8; out[4] = u8;
}
""",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel_name, iters=50):
    """Mean device time per call of fn() from one torch.profiler trace, read
    two ways: ``(total, own)``.  ``total`` sums the total device time of
    every event whose name holds ``kernel_name`` (the kernels' reading);
    ``own`` sums the self device time of CUDA events only, so each kernel
    counts once even under the empty filter a library call needs.  A trace
    that holds no such time at all is taken again, up to three traces; then
    each reading is None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel_name in e.key]
        total_us = sum(getattr(e, "device_time_total", 0.0) or 0.0 for e in events)
        own_us = sum(e.self_device_time_total for e in events
                     if e.device_type.name == "CUDA")
        if total_us > 0 or own_us > 0:
            break
    return tuple(us / 1e3 / iters if us > 0 else None for us in (total_us, own_us))


def kernel_device_ms(fn, kernel_name, iters=50):
    """``kernel_device_ms`` and ``kernel_self_device_ms`` of a kernel."""
    total, own = device_ms(fn, kernel_name, iters)
    return {"kernel_device_ms": total, "kernel_self_device_ms": own}


def library_device_ms(fn, iters=50):
    """Device time of every kernel that fn() launches, each counted once."""
    return device_ms(fn, "", iters)[1]


def tensor_core_instructions(build):
    """Per source, the HMMA and HGMMA instructions in ``cuobjdump -sass`` of
    its built library; None for every source where the toolkit has no
    cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    counts = {}
    for name in build.sources():
        if not os.access(tool, os.X_OK):
            counts[name] = None
            continue
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "HGMMA")}
    return counts


def step_breakdown(fn, iters=3, top=12):
    """Device busy share of ``iters`` calls of fn() (summed kernel time over
    host wall time, one stream) and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(t for _k, t, _c in kernels)
    kernels.sort(key=lambda k: -k[1])
    return {"iters": iters, "wall_ms_per_step": wall_us / 1e3 / iters,
            "device_busy_ms_per_step": busy_us / 1e3 / iters,
            "device_idle_share": 1.0 - busy_us / wall_us if busy_us else None,
            "top_kernels": [{"name": k[:80], "ms_per_step": t / 1e3 / iters,
                             "share_of_busy": t / busy_us, "calls_per_step": c / iters}
                            for k, t, c in kernels[:top]]}


def smce_inputs(n, d, dtype, seed, padding=True):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, d, generator=gen, device="cuda") * 3).to(dtype)
    labels = torch.randint(0, d, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if padding and n > 1:
        labels[0] = -1   # padding row
        labels[1] = d    # out of range
    return x, labels


def check_softmax_ce(entry, SoftmaxCE, plain_softmax_ce):
    """Kernel vs plain, forward (loss, probs) and backward; returns the
    largest absolute error at the main path's shape (32, 1000) f32."""
    cases = [(32, 1000, torch.float32), (13, 7, torch.float32),
             (256, 32000, torch.float32), (256, 32000, torch.bfloat16)]
    main_err = None
    for i, (n, d, dtype) in enumerate(cases):
        rtol, atol = entry.tolerance(dtype)
        x, labels = smce_inputs(n, d, dtype, seed=100 + i)
        before = entry.launches
        loss_k, prob_k = entry.kernel(x, labels)
        torch.cuda.synchronize()
        if entry.launches != before + 1:
            raise RuntimeError("softmax_ce wrapper did not launch its kernel")
        loss_p, prob_p = entry.plain(x, labels)
        torch.testing.assert_close(loss_k, loss_p, rtol=rtol, atol=atol)
        torch.testing.assert_close(prob_k.float(), prob_p.float(), rtol=rtol, atol=atol)
        ct = torch.rand(n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(i))
        xk = x.clone().requires_grad_(True)
        (SoftmaxCE.apply(xk, labels) * ct).sum().backward()
        xp = x.clone().requires_grad_(True)
        (plain_softmax_ce(xp, labels) * ct).sum().backward()
        torch.testing.assert_close(xk.grad.float(), xp.grad.float(), rtol=rtol, atol=atol)
        torch.cuda.synchronize()
        errs = {"loss": (loss_k - loss_p).abs().max().item(),
                "prob": (prob_k.float() - prob_p.float()).abs().max().item(),
                "grad": (xk.grad.float() - xp.grad.float()).abs().max().item()}
        if float(loss_k[0]) != 0.0 or float(loss_k[1]) != 0.0:
            raise RuntimeError("padding and out-of-range rows must have zero loss")
        emit("kernel_check", kernel=entry.name, shape=[n, d], dtype=str(dtype),
             rtol=rtol, atol=atol, max_abs_err=errs)
        if (n, d, dtype) == (32, 1000, torch.float32):
            main_err = max(errs.values())
    return main_err


def run_slice(build_train_step, library):
    step, params, _moms = build_train_step(batch=BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    losses = [float(step(x, y)) for _ in range(STEPS)]
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if launches["softmax_ce"] != STEPS:
        raise RuntimeError(f"softmax_ce launched {launches['softmax_ce']} times in "
                           f"{STEPS} steps")
    n_params = sum(w.numel() for w in params.values())
    emit("slice", model="resnet50_v1", batch=BATCH, image=IMAGE, dtype="float32",
         steps=STEPS, losses=losses, launches=launches, trainable_params=n_params,
         seconds=seconds)
    return step, x, y, launches


def run_parity(build_train_step, vision, Xavier):
    layers, channels, classes = NARROW
    net = vision.ResNetV1(vision.BottleneckV1, layers, channels, classes=classes)
    net.initialize(Xavier(), generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 3, 64, 64).astype(np.float32))
    y = torch.from_numpy(np.array([3, 0, 9, -1], np.int32))
    results = {}
    for device in ("cuda", "cpu"):
        local = copy.deepcopy(net)
        step, params, moms = build_train_step(batch=4, device=device, net=local)
        loss = step(x.to(device), y.to(device))
        aux = {n: p.data() for n, p in local.collect_params().items() if p.is_aux}
        results[device] = {"loss": loss, **{f"param:{k}": v for k, v in params.items()},
                           **{f"aux:{k}": v for k, v in aux.items()},
                           **{f"mom:{k}": v for k, v in moms.items()}}
    worst = 0.0
    for key, want in results["cpu"].items():
        got = results["cuda"][key].detach().cpu()
        torch.testing.assert_close(got, want.detach(), rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   msg=lambda m, key=key: f"{key}: {m}")
        worst = max(worst, (got - want.detach()).abs().max().item())
    emit("parity", net="ResNetV1(BottleneckV1, [1,1,1,1], [8,32,64,128,256], 10)",
         batch=4, image=64, tensors=len(results["cpu"]), rtol=PARITY_RTOL,
         atol=PARITY_ATOL, max_abs_err=worst, loss=float(results["cpu"]["loss"]))


def time_softmax_ce(entry):
    """Kernel, plain and library times at the main path's shape, and the bound."""
    import torch.nn.functional as F

    n, d = BATCH, 1000
    x, labels = smce_inputs(n, d, torch.float32, seed=7, padding=False)
    y64 = labels.long()

    def library():
        return (torch.softmax(x, dim=-1),
                F.cross_entropy(x, y64, reduction="none", ignore_index=-1))

    ms = cuda_ms(lambda: entry.kernel(x, labels), iters=500, warmup=20)
    plain_ms = cuda_ms(lambda: entry.plain(x, labels), iters=500, warmup=20)
    library_ms = cuda_ms(library, iters=500, warmup=20)
    # each input read once, each output written once: logits, labels in;
    # loss (f32) and probabilities (input dtype) out
    nbytes = x.numel() * x.element_size() + labels.numel() * 4 + n * 4 + \
        x.numel() * x.element_size()
    # per logit: max; sub, exp, add; sub, exp, div
    ops = 7 * n * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **kernel_device_ms(lambda: entry.kernel(x, labels), "smce_kernel"),
            "library_device_ms": library_device_ms(library),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _grads(fn, inputs, ct):
    """Gradients of ``fn(*inputs)`` under the cotangent ``ct``, taken with
    respect to fresh copies of ``inputs``."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    fn(*leaves).backward(ct)
    return [t.grad for t in leaves]


def check_layernorm(entry, LayerNormFn):
    """Kernel vs plain: y, mean, rstd and dx, dgamma, dbeta; returns the
    largest absolute error at the transformer path's shape (8192, 768) f32."""
    f32 = torch.float32
    cases = [(8192, 768, f32, 0.0), (13, 33, f32, 0.0), (4096, 1024, torch.bfloat16, 100.0)]
    main_err = None
    for i, (n, d, dtype, mu) in enumerate(cases):
        rtol, atol = entry.tolerance(dtype)
        srtol, satol = entry.tolerance(f32)   # mean, rstd and dgamma, dbeta are f32
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        x = (torch.randn(n, d, generator=gen, device="cuda") * 3 + mu).to(dtype)
        gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
        ct = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
        before = entry.launches
        yk, mk, rk = entry.kernel(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        if entry.launches != before + 1:
            raise RuntimeError("layernorm wrapper did not launch its kernel")
        yp, mp, rp = entry.plain(x, gamma, beta, 1e-5)
        torch.testing.assert_close(yk.float(), yp.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(mk, mp, rtol=srtol, atol=satol)
        torch.testing.assert_close(rk, rp, rtol=srtol, atol=satol)
        dxk, dgk, dbk = _grads(lambda *a: LayerNormFn.apply(*a, 1e-5), (x, gamma, beta), ct)
        dxp, dgp, dbp = _grads(lambda *a: entry.plain(*a, 1e-5)[0], (x, gamma, beta), ct)
        torch.testing.assert_close(dxk.float(), dxp.float(), rtol=rtol, atol=atol)
        for gk, gp in ((dgk, dgp), (dbk, dbp)):   # sums over n rows
            torch.testing.assert_close(gk, gp, rtol=srtol,
                                       atol=satol * max(1.0, gp.abs().max().item()))
        torch.cuda.synchronize()
        errs = {"y": _max_err(yk, yp), "mean": _max_err(mk, mp), "rstd": _max_err(rk, rp),
                "dx": _max_err(dxk, dxp), "dgamma": _max_err(dgk, dgp),
                "dbeta": _max_err(dbk, dbp)}
        emit("kernel_check", kernel=entry.name, shape=[n, d], dtype=str(dtype), row_mean=mu,
             rtol=rtol, atol=atol, stats_rtol=srtol, stats_atol=satol, max_abs_err=errs)
        if (n, d, dtype) == (8192, 768, f32):
            main_err = max(errs.values())
    return main_err


def attention_inputs(shape, dtype, layout, gen):
    """q, k, v and a cotangent of ``shape`` (B, H, S, D) on the card.
    ``contiguous``; ``head_split``, views of (B, S, H * D) as the block makes
    them; ``unaligned``, views sliced from a wider buffer at an offset of one
    element, whose rows start off 16-byte boundaries."""
    b, h, s, d = shape

    def one():
        if layout == "head_split":
            return (torch.randn(b, s, h * d, generator=gen, device="cuda").to(dtype)
                    .reshape(b, s, h, d).transpose(1, 2))
        if layout == "unaligned":
            wide = torch.randn(b, h, s, d + 3, generator=gen, device="cuda").to(dtype)
            view = wide[..., 1:d + 1]
            if view.data_ptr() % 16 == 0 or (view.stride(2) * view.element_size()) % 16 == 0:
                raise RuntimeError("the unaligned case is aligned")
            return view
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return one(), one(), one(), torch.randn(shape, generator=gen, device="cuda").to(dtype)


# (shape, causal, dtype, layout)
ATTENTION_CASES = [
    ((8, 12, 1024, 64), True, torch.float32, "contiguous"),
    ((2, 2, 100, 32), True, torch.float32, "contiguous"),
    ((1, 2, 64, 32), False, torch.float32, "contiguous"),
    ((2, 4, 256, 128), True, torch.bfloat16, "contiguous"),
    # the path's shape and layout
    ((8, 12, 1024, 64), True, torch.float32, "head_split"),
    ((8, 12, 1024, 64), True, torch.bfloat16, "head_split"),
    # ragged S and a head dim that is not a power of two
    ((1, 3, 333, 80), True, torch.float32, "contiguous"),
    ((2, 2, 256, 128), False, torch.float32, "contiguous"),
    # rows off 16-byte boundaries: the scalar staging path, at each padded
    # width (kD 32, 64, 128) in both types
    ((2, 3, 197, 40), True, torch.bfloat16, "unaligned"),
    ((1, 2, 96, 24), False, torch.bfloat16, "unaligned"),
    ((1, 2, 160, 128), True, torch.bfloat16, "unaligned"),
    ((2, 2, 77, 20), False, torch.float32, "unaligned"),
    ((1, 3, 150, 63), True, torch.float32, "unaligned"),
    ((1, 2, 130, 100), True, torch.float32, "unaligned"),
]
def check_attention(entry, FlashAttention):
    """Kernel vs plain: o, m, l and dq, dk, dv; returns the largest absolute
    error at the transformer path's shape (8, 12, 1024, 64) f32 causal, in
    both layouts.  bf16 o is also held to ``ATTENTION_HALF_ROW_ULPS``."""
    from mxnet_tpu_torch.kernels.library import ATTENTION_HALF_ROW_ULPS, row_ulps

    f32 = torch.float32
    main_err = 0.0
    for i, (shape, causal, dtype, layout) in enumerate(ATTENTION_CASES):
        rtol, atol = entry.tolerance(dtype)
        srtol, satol = entry.tolerance(f32)   # m and l are f32
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        q, k, v, ct = attention_inputs(shape, dtype, layout, gen)
        before = entry.launches
        ok, mk, lk = entry.kernel(q, k, v, causal)
        torch.cuda.synchronize()
        if entry.launches != before + 1:
            raise RuntimeError("attention wrapper did not launch its kernel")
        op, mp, lp = entry.plain(q, k, v, causal)
        torch.testing.assert_close(ok.float(), op.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(mk, mp, rtol=srtol, atol=satol)
        torch.testing.assert_close(lk, lp, rtol=srtol, atol=satol)
        extra = {}
        if dtype == torch.bfloat16:
            extra = {"o_row_ulps": row_ulps(ok, op),
                     "o_row_ulps_max": ATTENTION_HALF_ROW_ULPS}
            if extra["o_row_ulps"] > ATTENTION_HALF_ROW_ULPS:
                raise RuntimeError(f"bf16 o is {extra['o_row_ulps']:.2f} ulps of its row's "
                                   f"scale off the plain version at {shape}")
        grads_k = _grads(lambda *a: FlashAttention.apply(*a, causal, None), (q, k, v), ct)
        grads_p = _grads(lambda *a: entry.plain(*a, causal)[0], (q, k, v), ct)
        for gk, gp in zip(grads_k, grads_p):
            torch.testing.assert_close(gk.float(), gp.float(), rtol=rtol, atol=atol)
        torch.cuda.synchronize()
        errs = {"o": _max_err(ok, op), "m": _max_err(mk, mp), "l": _max_err(lk, lp),
                **{f"d{n}": _max_err(gk, gp) for n, gk, gp in zip("qkv", grads_k, grads_p)}}
        emit("kernel_check", kernel=entry.name, shape=list(shape), causal=causal,
             dtype=str(dtype), layout=layout, q_strides=list(q.stride()), rtol=rtol,
             atol=atol, stats_rtol=srtol, stats_atol=satol, max_abs_err=errs, **extra)
        if (shape, dtype) == ((8, 12, 1024, 64), f32):
            main_err = max(main_err, *errs.values())
        del q, k, v, ct, grads_k, grads_p
    return main_err


def _stack_forward(tp, pipeline, stacked, x, heads):
    return pipeline.pipeline_apply(
        lambda p, t: tp.transformer_block_ref(p, t, heads, causal=True), stacked, x)


def run_transformer_slice(library, tp, pipeline):
    """One forward of the full-width stack, launch counts reset just before."""
    c = GPT2_SMALL
    gen = torch.Generator(device="cuda").manual_seed(0)
    stacked = pipeline.stack_stage_params(
        [tp.init_transformer_params(c["embed"], c["ffn"], c["heads"], generator=gen)
         for _ in range(c["layers"])])
    x = torch.randn(c["batch"], c["seq"], c["embed"], generator=gen, device="cuda")

    def forward():
        with torch.no_grad():
            return _stack_forward(tp, pipeline, stacked, x, c["heads"])

    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"stack output {tuple(out.shape)} is not finite or not {tuple(x.shape)}")
    want = {"layernorm": 2 * c["layers"], "attention": c["layers"]}
    for name, count in want.items():
        if launches[name] != count:
            raise RuntimeError(f"{name} launched {launches[name]} times in one forward of "
                               f"{c['layers']} layers, expected {count}")
    n_params = sum(t.numel() for t in stacked.values())
    emit("slice_transformer", model="gpt2_small_block_stack", **c, causal=True,
         dtype="float32", params=n_params, launches=launches, seconds=seconds,
         out_abs_mean=out.abs().mean().item(), out_std=out.std().item())
    return forward, launches


def run_transformer_parity(tp, pipeline):
    """A narrow stack's forward and the gradients of out.sum() on the card
    (kernels) and on the CPU (plain versions), from the same weights."""
    c = NARROW_TF
    gen = torch.Generator().manual_seed(5)
    stages = []
    for _ in range(c["layers"]):
        p = tp.init_transformer_params(c["embed"], c["ffn"], c["heads"], generator=gen,
                                       device="cpu")
        for name in ("bq", "bk", "bv", "bo", "b1", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            p[name] = p[name] + 0.1 * torch.randn(p[name].shape, generator=gen)
        stages.append(p)
    stacked = pipeline.stack_stage_params(stages)
    x = torch.randn(c["batch"], c["seq"], c["embed"], generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        params = {k: v.to(device).requires_grad_(True) for k, v in stacked.items()}
        xd = x.to(device).requires_grad_(True)
        out = _stack_forward(tp, pipeline, params, xd, c["heads"])
        out.sum().backward()
        results[device] = {"out": out.detach(), "grad:x": xd.grad,
                           **{f"grad:{k}": v.grad for k, v in params.items()}}
    worst = 0.0
    for key, want in results["cpu"].items():
        got = results["cuda"][key].cpu()
        torch.testing.assert_close(got, want, rtol=PARITY_TF_TOL,
                                   atol=PARITY_TF_TOL * max(1.0, want.abs().max().item()),
                                   msg=lambda m, key=key: f"{key}: {m}")
        worst = max(worst, (got - want).abs().max().item())
    emit("parity_transformer", **c, causal=True, tensors=len(results["cpu"]),
         rtol=PARITY_TF_TOL, atol_per_unit_max=PARITY_TF_TOL, max_abs_err=worst)


def time_layernorm(entry):
    """Kernel, plain and library times at the path's shape, and the bound."""
    n, d = GPT2_SMALL["batch"] * GPT2_SMALL["seq"], GPT2_SMALL["embed"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(n, d, generator=gen, device="cuda")
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    ms = cuda_ms(lambda: entry.kernel(x, gamma, beta), iters=200, warmup=20)
    plain_ms = cuda_ms(lambda: entry.plain(x, gamma, beta), iters=200, warmup=20)

    def library():
        return torch.native_layer_norm(x, (d,), gamma, beta, 1e-5)

    library_ms = cuda_ms(library, iters=200, warmup=20)
    # each input read once, each output written once: x, gamma, beta in;
    # y, mean, rstd out
    nbytes = 2 * x.numel() * x.element_size() + 2 * d * 4 + 2 * n * 4
    # per element: sum; sub, mul-add (squares); sub, mul, mul, add
    ops = 7 * n * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"shape": [n, d], "dtype": "float32", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch.native_layer_norm",
            **kernel_device_ms(lambda: entry.kernel(x, gamma, beta), "ln_fwd_kernel"),
            "library_device_ms": library_device_ms(library),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


def time_attention(entry):
    """Kernel, plain and library times at the path's shape and layout (q, k
    and v as head-split views of (batch, seq, embed)), f32 and bf16, and the
    bounds.  ``bound_ms`` is the least time for the work at the rate of the
    arithmetic the kernel runs: three TF32 products for f32 (the tensor
    cores' way to f32 accuracy), bf16 tensor cores for bf16.  For f32,
    ``bound_cuda_cores_ms`` is the bound of strict f32 on the CUDA cores."""
    import torch.nn.functional as F

    c = GPT2_SMALL
    b, s, h, e = c["batch"], c["seq"], c["heads"], c["embed"]
    dh = e // h
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(b, s, e, generator=gen, device="cuda")
               .reshape(b, s, h, dh).transpose(1, 2) for _ in range(3))
    # the pairs the causal mask keeps, S(S+1)/2 per head: 2*dh for q.k and
    # 2*dh for p*v each
    ops = 4 * dh * b * h * s * (s + 1) // 2

    def timed(q, k, v, ops_per_s, tc_ops):
        def kernel():
            return entry.kernel(q, k, v, True)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        # q, k, v in; o, m, l out
        nbytes = 4 * q.numel() * q.element_size() + 2 * b * h * s * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = tc_ops / ops_per_s * 1e3
        return {"shape": [b, h, s, dh], "causal": True, "dtype": str(q.dtype),
                "ms": cuda_ms(kernel, iters=50, warmup=5),
                **kernel_device_ms(kernel, "flash_attn_mma_kernel", iters=20),
                # o only: SDPA returns no running max or sum
                "library_ms": cuda_ms(sdpa, iters=50, warmup=5),
                "library_device_ms": library_device_ms(sdpa, iters=20),
                "library": "F.scaled_dot_product_attention(is_causal=True), o only",
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": ops, "tensor_core_operations": tc_ops,
                "tensor_core_ops_per_s": ops_per_s}

    f32 = timed(q, k, v, TF32_OPS_PER_S, 3 * ops)
    f32["bound_cuda_cores_ms"] = max(f32["bytes"] / HBM_BYTES_PER_S,
                                     ops / FP32_OPS_PER_S) * 1e3
    f32["plain_ms"] = cuda_ms(lambda: entry.plain(q, k, v, True), iters=10, warmup=2)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))   # the same head-split strides
    f32["bf16"] = timed(qb, kb, vb, BF16_OPS_PER_S, ops)
    return f32


def _raises(fn, match):
    """The MXNetError message of fn(); fails unless it raises one holding ``match``."""
    from mxnet_tpu_torch.base import MXNetError

    try:
        fn()
    except MXNetError as e:
        if match not in str(e):
            raise RuntimeError(f"error without {match!r}: {e}") from e
        return str(e).splitlines()[0][:200]
    raise RuntimeError(f"expected MXNetError holding {match!r}; nothing was raised")


def run_rtc_semantics(mx, nd, rtc):
    """The cases of tests/test_rtc.py in CUDA C through mx.rtc, each result
    exact; a compile error and a 2048-thread launch must raise."""
    gpu = mx.gpu(0)
    seconds, cases = {}, {}

    def module(name, src, **kw):
        mod = rtc.CudaModule(src, **kw)
        seconds[name] = mod.compile_seconds
        return mod

    def exact(case, got, want):
        np.testing.assert_array_equal(got.asnumpy(), want, err_msg=case)
        cases[case] = "ok"

    axpy = module("axpy", AXPY_SRC).get_kernel("axpy", AXPY_SIG)
    x, y = nd.ones((10,), ctx=gpu), nd.zeros((10,), ctx=gpu)
    axpy.launch([x, y, 3.0], gpu, (1, 1, 1), (10, 1, 1))
    exact("axpy_first", y, np.full(10, 3.0, np.float32))
    axpy.launch([x, y, 3.0], gpu, (1, 1, 1), (10, 1, 1))
    exact("axpy_second", y, np.full(10, 6.0, np.float32))
    if (y.version, x.version) != (2, 0):
        raise RuntimeError(f"versions after two launches: y {y.version}, x {x.version}")

    k = module("scale2", RTC_CASES_SRC["scale2"]).get_kernel(
        "scale2", "const float *x, float *a, float *b")
    xn = np.arange(6, dtype=np.float32).reshape(2, 3)
    a, b = nd.zeros((2, 3), ctx=gpu), nd.zeros((2, 3), ctx=gpu)
    k.launch([nd.array(xn, ctx=gpu), a, b], gpu, (1, 1, 1), (6, 1, 1))
    exact("two_outputs_a", a, xn * 2)
    exact("two_outputs_b", b, xn * 3)

    k = module("rowscale", RTC_CASES_SRC["rowscale"]).get_kernel(
        "rowscale", "const float *x, float *y, float alpha, int cols")
    xn = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = nd.zeros((8, 4), ctx=gpu)
    k.launch([nd.array(xn, ctx=gpu), y, 0.5, 4], gpu, (8, 1, 1), (4, 1, 1))
    exact("rows_by_blockIdx", y, xn * np.float32(0.5))

    k = module("addi", RTC_CASES_SRC["addi"]).get_kernel(
        "addi", "const int32 *x, int32 *y, int32 k")
    y = nd.zeros((5,), ctx=gpu, dtype="int32")
    k.launch([nd.array(np.arange(5, dtype=np.int32), ctx=gpu), y, 7], gpu, (1,), (5,))
    exact("int32", y, np.arange(5, dtype=np.int32) + 7)

    mod = module("scale_t", RTC_CASES_SRC["scale_t"],
                 exports=["scale_t<float>", "scale_t<double>"])
    k = mod.get_kernel("scale_t<double>", "const double *x, double *y, double alpha, int n")
    xn = np.linspace(-1, 1, 300)
    y = nd.zeros((300,), ctx=gpu, dtype="float64")
    k.launch([nd.array(xn, ctx=gpu, dtype="float64"), y, 0.25, 300], gpu, (3,), (128,))
    exact("template_through_exports", y, xn * 0.25)
    cases["unexported_name"] = _raises(lambda: mod.get_kernel("scale_t", "int n"), "exports")

    n = 100 * 1024 // 4
    k = module("smem_reverse", RTC_CASES_SRC["smem_reverse"]).get_kernel(
        "smem_reverse", "const float *x, float *y, int n")
    xn = np.arange(n, dtype=np.float32)
    y = nd.zeros((n,), ctx=gpu)
    k.launch([nd.array(xn, ctx=gpu), y, n], gpu, (1,), (256,), shared_mem=n * 4)
    exact("dynamic_shared_100KiB", y, xn[::-1])

    k = module("scalars", RTC_CASES_SRC["scalars"]).get_kernel(
        "scalars", "float *out, half h, bfloat16 b, double d, int8 i8, uint8 u8")
    out = nd.zeros((5,), ctx=gpu)
    k.launch([out, 0.1, 0.1, -2.5, -3, 250], gpu, (1,), (1,))
    bf16_bits = torch.tensor(0.1, dtype=torch.bfloat16).view(torch.int16).item()
    exact("scalar_packing", out, np.array([np.float16(0.1).view(np.uint16), bf16_bits,
                                           -2.5, -3, 250], np.float32))

    t0 = time.perf_counter()
    cases["compile_error"] = _raises(
        lambda: rtc.CudaModule('extern "C" __global__ void broken(float *x) '
                               '{ x[0] = undefined_name; }'), "undefined_name")
    seconds["compile_error"] = time.perf_counter() - t0
    big = [nd.ones((2048,), ctx=gpu), nd.zeros((2048,), ctx=gpu), 1.0]
    cases["block_of_2048_threads"] = _raises(
        lambda: axpy.launch(big, gpu, (1, 1, 1), (2048, 1, 1)), "cuLaunchKernel")
    if big[1].version != 0 or big[1].asnumpy().any():
        raise RuntimeError("the refused 2048-thread launch wrote its output")
    cases["unknown_kernel"] = _raises(lambda: rtc.CudaModule(AXPY_SRC).get_kernel(
        "nope", "const float *x"), "no kernel 'nope'")
    cases["cpu_context"] = _raises(
        lambda: axpy.launch([x, y, 1.0], mx.cpu(), (1,), (10,)), "no CPU path")
    torch.cuda.synchronize()
    emit("rtc", nvrtc=rtc.nvrtc_version(), arch=rtc.ARCH, compile_seconds=seconds,
         cases=cases, launches_total=rtc.launches)


def _axpy_dims(n):
    """(grid, block) for the doc axpy over ``n`` elements: a block size that
    divides ``n`` (the kernel has no bounds check) and leaves the fewest
    idle lanes in its last warp, the larger on a tie."""
    divisors = [d for d in range(32, 1025) if n % d == 0]
    if not divisors:
        raise RuntimeError(f"{n} has no divisor in [32, 1024] for the doc axpy")
    block = max(divisors, key=lambda d: (d / (32 * math.ceil(d / 32)), d))
    return n // block, block


def _sgd_mom_dims(n):
    return min(math.ceil(n / SGD_MOM_THREADS), SGD_MOM_MAX_BLOCKS), SGD_MOM_THREADS


def run_rtc_full_width(mx, nd, rtc, library, vision, Xavier, sgd_mom_update):
    """The slice at full width: ResNet-50 v1's trainable tensors as
    NDArrays (no copy), the sgd_mom kernel once per tensor, the doc axpy
    over 25 575 912 floats, and the .params round trip of the whole net."""
    gpu = mx.gpu(0)
    net = vision.resnet50_v1()
    net.initialize(Xavier(), generator=torch.Generator().manual_seed(0))
    net.to("cuda")
    weights = [p.data().detach() for p in net.collect_params().values()
               if p.data().requires_grad]
    n_params = sum(w.numel() for w in weights)
    if n_params != RESNET50_TRAINABLE:
        raise RuntimeError(f"resnet50_v1 has {n_params} trainable parameters")
    gen = torch.Generator(device="cuda").manual_seed(11)
    grads = [torch.randn(w.shape, generator=gen, device="cuda") for w in weights]
    moms = [0.01 * torch.randn(w.shape, generator=gen, device="cuda") for w in weights]
    ref = [(w.clone(), g.clone(), m.clone()) for w, g, m in zip(weights, grads, moms)]
    W, G, M = ([nd.from_dlpack(t) for t in ts] for ts in (weights, grads, moms))
    for arr, t in zip(W + G + M, weights + grads + moms):
        if torch.from_dlpack(nd.to_dlpack_for_read(arr)).data_ptr() != t.data_ptr():
            raise RuntimeError("nd.from_dlpack copied a tensor")
    sgd = rtc.CudaModule(SGD_MOM_SRC)
    sgd_k = sgd.get_kernel("sgd_mom", SGD_MOM_SIG)
    axpy_mod = rtc.CudaModule(AXPY_SRC)
    axpy_k = axpy_mod.get_kernel("axpy", AXPY_SIG)
    x = torch.randn(RESNET50_TRAINABLE, generator=gen, device="cuda")
    y = torch.randn(RESNET50_TRAINABLE, generator=gen, device="cuda")
    y_ref, alpha = y.clone(), 0.5
    X, Y = nd.from_dlpack(x), nd.from_dlpack(y)
    grid, block = _axpy_dims(RESNET50_TRAINABLE)
    scalars = [SGD["lr"], SGD["momentum"], SGD["wd"], SGD["rescale_grad"]]

    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    for g, w, m in zip(G, W, M):
        blocks, threads = _sgd_mom_dims(w.size)
        sgd_k.launch([g, w, m, *scalars, w.size], gpu, (blocks, 1, 1), (threads, 1, 1))
    axpy_k.launch([X, Y, alpha], gpu, (grid, 1, 1), (block, 1, 1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"sgd_mom": sgd_k.launches, "axpy": axpy_k.launches, "rtc": rtc.launches,
                **{name: k.launches for name, k in library.KERNELS.items()}}
    if (launches["sgd_mom"], launches["axpy"], launches["rtc"]) != \
            (len(weights), 1, len(weights) + 1):
        raise RuntimeError(f"launches {launches} for {len(weights)} tensors")
    if any(a.version != 1 for a in W + M) or any(a.version != 0 for a in G):
        raise RuntimeError("outputs must be bumped once and inputs never")

    errs = {"weight": 0.0, "mom": 0.0}
    for (rw, rg, rm), w, m in zip(ref, weights, moms):
        sgd_mom_update(rw, rg, rm, lr=SGD["lr"], wd=SGD["wd"], momentum=SGD["momentum"],
                       rescale_grad=SGD["rescale_grad"])
        torch.testing.assert_close(w, rw, rtol=RTC_RTOL, atol=RTC_ATOL)
        torch.testing.assert_close(m, rm, rtol=RTC_RTOL, atol=RTC_ATOL)
        errs["weight"] = max(errs["weight"], _max_err(w, rw))
        errs["mom"] = max(errs["mom"], _max_err(m, rm))
    y_ref += alpha * x
    torch.testing.assert_close(y, y_ref, rtol=RTC_RTOL, atol=RTC_ATOL)
    errs["axpy"] = _max_err(y, y_ref)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                        "_build", "resnet50_v1.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t1 = time.perf_counter()
    net.save_parameters(path)
    save_s, file_bytes = time.perf_counter() - t1, os.path.getsize(path)
    other = vision.resnet50_v1()
    other.initialize(Xavier(), generator=torch.Generator().manual_seed(1))
    other.to("cuda")
    t1 = time.perf_counter()
    other.load_parameters(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    os.remove(path)
    mine, theirs = net._collect_params_with_prefix(), other._collect_params_with_prefix()
    if list(mine) != list(theirs):
        raise RuntimeError("the two nets' structured names differ")
    unequal = [k for k in mine if not torch.equal(mine[k].data(), theirs[k].data())]
    if unequal:
        raise RuntimeError(f"{len(unequal)} tensors differ after the round trip: {unequal[:3]}")
    emit("rtc_full_width", model="resnet50_v1", trainable_params=n_params,
         trainable_tensors=len(weights), sgd=SGD, axpy_elements=RESNET50_TRAINABLE,
         axpy_grid=[grid, 1, 1], axpy_block=[block, 1, 1], launches=launches,
         seconds=seconds, rtol=RTC_RTOL, atol=RTC_ATOL, max_abs_err=errs,
         nvrtc_compile_seconds={"sgd_mom": sgd.compile_seconds,
                                "axpy": axpy_mod.compile_seconds},
         params_file_bytes=file_bytes, params_tensors=len(mine), save_seconds=save_s,
         load_seconds=load_s, round_trip="bit-equal")
    state = {"gpu": gpu, "sgd_k": sgd_k, "axpy_k": axpy_k, "G": G, "W": W, "M": M,
             "X": X, "Y": Y, "x": x, "y": y, "alpha": alpha, "grid": grid, "block": block,
             "scalars": scalars, "weights": weights, "grads": grads, "moms": moms}
    return state, launches, max(errs.values())


def time_rtc(st, sgd_mom_update):
    """The doc axpy at 25 575 912 f32 and the sgd_mom pass over ResNet-50:
    kernel, device, plain and library times, and the bounds."""
    gpu, axpy_k, X, Y, x, y = st["gpu"], st["axpy_k"], st["X"], st["Y"], st["x"], st["y"]
    alpha, grid, block = st["alpha"], st["grid"], st["block"]
    n = x.numel()

    def axpy():
        axpy_k.launch([X, Y, alpha], gpu, (grid, 1, 1), (block, 1, 1))

    def plain_axpy():
        y.add_(alpha * x)

    ms = cuda_ms(axpy, iters=200, warmup=10)
    plain_ms = cuda_ms(plain_axpy, iters=200, warmup=10)
    library_ms = cuda_ms(lambda: y.add_(x, alpha=alpha), iters=200, warmup=10)
    # x read, y read and written; one multiply-add an element
    nbytes, ops = 3 * n * 4, 2 * n
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    axpy_t = {"shape": [n], "dtype": "float32", "grid": [grid, 1, 1], "block": [block, 1, 1],
              "ms": ms, "plain_ms": plain_ms, "plain": "y += alpha * x",
              "library_ms": library_ms, "library": "y.add_(x, alpha=alpha)",
              **kernel_device_ms(axpy, "axpy"),
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "bytes": nbytes, "operations": ops}

    sgd_k, scalars = st["sgd_k"], st["scalars"]
    tensors = list(zip(st["G"], st["W"], st["M"]))

    def sgd_pass():
        for g, w, m in tensors:
            blocks, threads = _sgd_mom_dims(w.size)
            sgd_k.launch([g, w, m, *scalars, w.size], gpu, (blocks, 1, 1), (threads, 1, 1))

    def plain_pass():
        for w, g, m in zip(st["weights"], st["grads"], st["moms"]):
            sgd_mom_update(w, g, m, lr=SGD["lr"], wd=SGD["wd"], momentum=SGD["momentum"],
                           rescale_grad=SGD["rescale_grad"])

    total = sum(w.numel() for w in st["weights"])
    pass_ms = cuda_ms(sgd_pass, iters=20, warmup=2)
    t0 = time.perf_counter()
    for _ in range(20):
        sgd_pass()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20   # enqueue only: no synchronize
    torch.cuda.synchronize()
    plain_pass_ms = cuda_ms(plain_pass, iters=10, warmup=2)
    # grad read; weight and mom read and written; 7 operations an element
    nbytes, ops = 5 * total * 4, 7 * total
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    sgd_t = {"tensors": len(tensors), "elements": total, "ms": pass_ms,
             "host_enqueue_ms": host_ms, "host_us_per_launch": host_ms * 1e3 / len(tensors),
             "plain_ms": plain_pass_ms, "plain": "sgd_mom_update per tensor",
             "library_ms": None,
             "library": "none: no single PyTorch call computes MXNet's sgd_mom_update",
             **kernel_device_ms(sgd_pass, "sgd_mom", iters=10),
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "bytes": nbytes, "operations": ops}
    return axpy_t, sgd_t


def kernel_row(entry, launches, max_abs_err, t, **extra):
    return {"name": entry.name, "route": entry.route, "source": entry.source,
            "replaces": entry.replaces, "launches": launches, "max_abs_err": max_abs_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_device_ms": t["kernel_device_ms"],
            "kernel_self_device_ms": t["kernel_self_device_ms"],
            "library_device_ms": t["library_device_ms"], **extra}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; one CUDA device "
              "is needed", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, rtc
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.kernels import build, library
    from mxnet_tpu_torch.ops.optimizer import sgd_mom_update
    from mxnet_tpu_torch.ops.attention import FlashAttention
    from mxnet_tpu_torch.ops.layer_norm import LayerNormFn
    from mxnet_tpu_torch.ops.softmax_ce import SoftmaxCE, plain_softmax_ce
    from mxnet_tpu_torch.parallel import pipeline, tp
    from mxnet_tpu_torch.train_step import build_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32=False)

    t0 = time.perf_counter()
    compiled = build.build()
    emit("build", sources=build.sources(), nvcc=build.nvcc(), flags=list(build.NVCC_FLAGS),
         per_source_seconds=compiled, seconds=time.perf_counter() - t0,
         tensor_core_instructions=tensor_core_instructions(build))

    entry = library.get("softmax_ce")
    ln_entry, attn_entry = library.get("layernorm"), library.get("attention")
    main_err = check_softmax_ce(entry, SoftmaxCE, plain_softmax_ce)
    ln_err = check_layernorm(ln_entry, LayerNormFn)
    attn_err = check_attention(attn_entry, FlashAttention)

    step, x, y, launches = run_slice(build_train_step, library)
    run_parity(build_train_step, vision, Xavier)
    forward, tf_launches = run_transformer_slice(library, tp, pipeline)
    run_transformer_parity(tp, pipeline)
    run_rtc_semantics(mx, nd, rtc)
    rtc_state, rtc_launches, rtc_err = run_rtc_full_width(mx, nd, rtc, library, vision,
                                                          Xavier, sgd_mom_update)

    step_ms = cuda_ms(lambda: step(x, y), iters=10, warmup=2)
    smce = time_softmax_ce(entry)
    profile = step_breakdown(lambda: step(x, y))
    # the profiler slows the host, so its own idle share overstates the
    # idle time of an unprofiled step: set its busy time against step_ms too
    emit("timing", tf32=False, train_step_ms=step_ms, img_per_s=BATCH / step_ms * 1e3,
         softmax_ce=smce, train_step_profile=profile,
         device_idle_share_vs_step_ms=1.0 - profile["device_busy_ms_per_step"] / step_ms)

    c = GPT2_SMALL
    fwd_ms = cuda_ms(forward, iters=10, warmup=2)
    ln_t, attn_t = time_layernorm(ln_entry), time_attention(attn_entry)
    fwd_profile = step_breakdown(forward)
    emit("timing_transformer", tf32=False, forward_ms=fwd_ms,
         tokens_per_s=c["batch"] * c["seq"] / fwd_ms * 1e3, layernorm=ln_t, attention=attn_t,
         forward_profile=fwd_profile,
         device_idle_share_vs_forward_ms=1.0 - fwd_profile["device_busy_ms_per_step"] / fwd_ms)

    axpy_t, sgd_t = time_rtc(rtc_state, sgd_mom_update)
    emit("timing_rtc", tf32=False, axpy=axpy_t, sgd_mom_pass=sgd_t)

    kernels = [kernel_row(entry, launches[entry.name], main_err, smce),
               kernel_row(ln_entry, tf_launches[ln_entry.name], ln_err, ln_t),
               kernel_row(attn_entry, tf_launches[attn_entry.name], attn_err, attn_t,
                          bound_cuda_cores_ms=attn_t["bound_cuda_cores_ms"],
                          bf16={key: attn_t["bf16"][key] for key in (
                              "ms", "kernel_device_ms", "kernel_self_device_ms",
                              "library_ms", "library_device_ms", "bound_ms", "bound_by")}),
               {"name": "rtc", "route": f"nvrtc {rtc.ARCH}", "source": "mxnet_tpu_torch/rtc.py",
                "replaces": "mxnet_tpu/rtc.py:88", "launches": rtc_launches["rtc"],
                "max_abs_err": rtc_err, **{k: axpy_t[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "timed": f"the doc axpy over {RESNET50_TRAINABLE} f32",
                "kernel_sources": "chip_smoke.py AXPY_SRC, SGD_MOM_SRC",
                "sgd_mom_pass": {k: sgd_t[k] for k in (
                    "tensors", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                    "host_us_per_launch")}}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
