"""The port's kernels, one entry each (counterpart of
``mxnet_tpu/kernels/library.py``).

An entry holds the kernel's wrapper (which launches on a CUDA tensor and
counts its launches), its plain PyTorch version, the tolerance the two are
held to, its source and the TPU kernel it replaces.  The JAX package's
autotuner and its ``MXNET_KERNELS`` mode switch are not ported: on the card
the wrapper always launches the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .. import rtc
from ..ops import attention, layer_norm, softmax_ce


@dataclass(frozen=True)
class Kernel:
    name: str
    kernel: Callable       # wrapper: launches on CUDA tensors, counts launches
    plain: Callable        # same function in plain PyTorch, same outputs
    tolerance: Callable    # dtype -> (rtol, atol)
    source: str            # path of the kernel's source in the repo
    replaces: str          # file:line of the TPU kernel
    route: str = "cuda"

    @property
    def launches(self):
        return self.kernel.launches


def _half_width(dtype):
    return torch.empty((), dtype=dtype).element_size() < 4


def smce_tol(dtype):
    """(rtol, atol) of softmax_ce against its plain version, as
    ``library.py:_smce_tol``: 2e-5 in f32, 2e-2 in bf16."""
    return (2e-2, 2e-2) if _half_width(dtype) else (2e-5, 2e-5)


def layernorm_tol(dtype):
    """(rtol, atol) of layernorm against its plain version.  f32: 2e-5, as
    ``library.py:_row_kernel_tol``.  bf16: 1e-2, tighter than that entry's
    2e-1, which covers a reference that accumulates in bf16; here both
    sides keep f32 statistics and differ by at most one bf16 rounding of
    the output (2**-7 relative)."""
    return (1e-2, 1e-2) if _half_width(dtype) else (2e-5, 2e-5)


def attention_tol(dtype):
    """(rtol, atol) of attention against its plain version, as
    ``library.py:_attn_tol``: 2e-4 in f32 (the online softmax reassociates
    the row sums), 4e-2 in bf16."""
    return (4e-2, 4e-2) if _half_width(dtype) else (2e-4, 2e-4)


# half-width attention o at long S: a typical |o| (about 0.05 at S = 1024)
# lies below the 4e-2 atol, so o is also held to a few ulps of the larger of
# each element and its row's RMS (the output's rounding gives about one)
ATTENTION_HALF_ROW_ULPS = 4.0


def row_ulps(got, want):
    """The largest ``|got - want|`` in ulps of ``got``'s dtype, each element's
    ulp taken at the larger of ``|want|`` and the RMS of its row."""
    eps = torch.finfo(got.dtype).eps
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return ((got - want).abs() / (torch.maximum(want.abs(), rms) * eps)).max().item()


KERNELS = {
    "softmax_ce": Kernel(
        name="softmax_ce",
        kernel=softmax_ce.softmax_ce_fwd,
        plain=softmax_ce.plain_softmax_ce_fwd,
        tolerance=smce_tol,
        source="mxnet_tpu_torch/csrc/softmax_ce.cu",
        replaces="mxnet_tpu/ops/pallas_softmax_ce.py:30",
    ),
    "layernorm": Kernel(
        name="layernorm",
        kernel=layer_norm.layer_norm_fwd,
        plain=layer_norm.plain_layer_norm_fwd,
        tolerance=layernorm_tol,
        source="mxnet_tpu_torch/csrc/layer_norm.cu",
        replaces="mxnet_tpu/ops/pallas_norm.py:24",
    ),
    "attention": Kernel(
        name="attention",
        kernel=attention.flash_attention_fwd,
        plain=attention.plain_flash_attention_fwd,
        tolerance=attention_tol,
        source="mxnet_tpu_torch/csrc/flash_attention.cu",
        replaces="mxnet_tpu/ops/pallas_attention.py:44",
    ),
}


def get(name):
    return KERNELS[name]


def reset_launches():
    """Set every kernel's launch count to 0, ``mx.rtc``'s total included."""
    for k in KERNELS.values():
        k.kernel.launches = 0
    rtc.reset_launches()
