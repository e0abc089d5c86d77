"""Monitor: per-output statistics during training (counterpart of
``mxnet_tpu/monitor.py``; parity: python/mxnet/monitor.py, the executor hook
of graph_executor.cc:1403).

A ``Monitor`` hooks every output of an executor on the host through
``Executor.set_monitor_callback``, which a captured train step cannot offer:
the fused step and the scanned window are one CUDA graph with no per-output
host boundary.  So a Module with a monitor installed runs the per-parameter
loop (``Module._fused_eligible``).  For training-health statistics that do
run inside the fused step, arm the numerics observatory
(``MXNET_NUMERICS=warn``) and read ``numerics_summary()``: the gradient and
parameter norms, the update ratio and the loss proxy, computed inside the
graph and exported through the telemetry registry.
"""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray


def numerics_summary(last_n=64):
    """``Monitor.toc()``-shaped rows ``[(step, stat_name, value_str)]`` from
    the numerics observatory's history: the fused-compatible alternative to
    ``Monitor(stat_func=...)`` (``MXNET_NUMERICS`` armed)."""
    from .telemetry import numerics
    return numerics.monitor_summary(last_n)


class Monitor:
    """Install a callback on executors to collect output statistics; a
    Module with one installed does not run the fused step (see the module
    docstring)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return x.norm() / (x.size ** 0.5)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Install the monitor on an executor."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this iteration if the interval elapsed."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting and return the list of ``(step, name, stat)``."""
        if not self.activated:
            return []
        self.activated = False
        res = []
        queue = self.queue
        if self.sort:
            queue = sorted(queue, key=lambda x: x[1])
        for n, k, v_list in queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            for v in v_list:
                assert isinstance(v, NDArray)
                if v.shape == (1,) or v.shape == ():
                    res.append((n, k, str(v.asscalar())))
                else:
                    res.append((n, k, str(v.asnumpy())))
        self.queue = []
        return res

    def toc_print(self):
        """Stop collecting and log the results."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)


__all__ = ["Monitor", "numerics_summary"]
