"""Dynamic loss scaler (counterpart of ``mxnet_tpu/amp/loss_scaler.py``).

With bfloat16 scaling is rarely needed, since bf16 has f32's exponent
range; the scaler is for fp16: multiply the loss up, check the gradients
for inf and nan, halve the scale on overflow, double it after a streak of
clean steps.  The backoff and growth sequence is the JAX package's.

``has_overflow`` goes through the numerics observatory's fused check
(``telemetry.numerics.host_all_finite``: one ``multi_all_finite``
reduction and one host read).  A scaler attached to the observatory
(``telemetry.numerics.attach_loss_scaler``) is fed each step's finite flag
at the window boundary of an armed fused step or scanned window, where the
flag was computed inside the captured graph, so it needs no check of its
own; a scaler that is not attached keeps its own check.
"""
from __future__ import annotations


class LossScaler:
    def __init__(self, init_scale=2. ** 16, scale_factor=2.,
                 scale_window=2000, tolerance=0.05):
        del tolerance   # accepted for parity; the JAX scaler ignores it too
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, grads):
        """True if any gradient (tensor or NDArray; None entries are
        skipped) holds inf or nan: one fused finiteness reduction over the
        list and one host read (``numerics.host_all_finite``)."""
        from ..telemetry import numerics as _numerics
        return not _numerics.host_all_finite(grads)

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1)
            self._unskipped = 0
        else:
            self._unskipped += 1
        if self._unskipped == self._scale_window:
            self.loss_scale = min(self.loss_scale * self._scale_factor, 2. ** 24)
            self._unskipped = 0

    def update_from_window(self, overflow_flags):
        """Feed one window's per-step overflow verdicts: the same sequence as
        that many ``update_scale`` calls."""
        for flag in overflow_flags:
            self.update_scale(bool(flag))
