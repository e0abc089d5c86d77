"""The fused train step of the PyTorch port: forward, backward and the
optimizer update of a Module as one CUDA graph a step (counterpart of
``mxnet_tpu/fused_step.py``: ``FusedTrainStep`` :64, ``ScanTrainStep``
:373).

The JAX package traces the step into one donated ``jax.jit`` dispatch.
Here the step is a function on the Module's own tensors: the executor's
walk (``Executor._build_fn``) under torch's autograd from fresh leaves
over the trainable weights, ``torch.autograd.grad`` with all-ones head
gradients (what ``Executor.backward`` takes), the aux states written back
in place, the optimizer's ``fused_update`` over the lists
(``torch._foreach_*``, the per-parameter ops' arithmetic), and the
gradient arrays zeroed, as the JAX step leaves them.  So the fused step
runs the kernels of the per-parameter loop (``MXNET_FUSED_STEP=0``) on the
same inputs.

On the card the step is captured as one CUDA graph, as
``train_step.capture_train_step`` captures bench's step: ``CAPTURE_WARMUP``
steps on a side stream, one captured, and every tensor the step writes put
back as it was.  A step then copies its batch into the executor's bound
data and label arrays and replays.  The graph owns the buffers of the
weights, aux states, optimizer states and gradients (the counterpart of
XLA's donation): where ``set_params``, a load or ``set_optimizer_states``
has put a new tensor in an array's place, its values are copied into the
graph's buffer and the array points at that buffer again; a new signature
(the optimizer's static hyperparameters, a shape or dtype, how the
parameters share their learning rate and weight decay) captures anew.  The
learning rates and weight decays are a device tensor written before a
replay when they changed, so a schedule does not capture anew.  A capture
or a replay that fails raises: nothing falls back to the per-parameter
loop.  On the CPU the same function runs eagerly.

``ScanTrainStep`` captures K steps, each over ``MXNET_SCAN_ACCUM`` = M
micro-batches whose gradients are summed before one update, as one graph
over a staged ``io.SuperBatch`` of K x M batches.

Launch counts follow ``capture_train_step``'s rule: a kernel wrapper
counts its launches at the warm-up steps and at the capture, never at a
replay.  Each step counts one ``fused_step`` dispatch and each window one
``scan_window`` (``profiler.dispatch_counts()``), whether it ran eagerly or
as a replay, and sets the ``train:fused_step_total`` counter lane.

The numerics observatory (``telemetry/numerics.py``, ``MXNET_NUMERICS``)
lives inside the same function, so inside the same graph: with the mode
armed, each step after its backward multiplies its (summed) gradients by
the ``train/poison_grad`` scalar when that chaos site is armed, computes
its stat row (``numerics.trace_step``: one multi-tensor norm, one
``index_add_`` into the buckets, the loss proxy, the finite flag) before
the update, and in ``skip`` mode puts back, after the update, the weights,
optimizer states and aux states it held from its start wherever the flag is
false (``numerics.UpdateGate``).  The window copies the weights at its
start and fills its last row with the parameter norm and the update ratio
(``numerics.window_param_stats``).  The rows are a tensor the graph owns;
the host reads it once a window and judges it (``numerics.observe_window``),
where ``halt`` raises ``NonFiniteError`` once the outputs and the arrays
are consistent.  A scanned window is judged as it returns; a single step
copies its row to pinned host memory without waiting and is judged by
``observe()``, which ``Module.update`` calls after the fit loop has staged
the next batch (and the next step calls first), so the read does not
serialize the loop's host work with the device's.  The mode and whether
the poison site is armed join the capture signature, so arming captures
anew; the poison scalar is a 0-d device tensor written before each run, as
the learning rates are.  ``warn`` and ``halt`` only read: their weights are
bit for bit those of ``off``.
"""
from __future__ import annotations

import time

import torch

from . import profiler as _prof
from . import telemetry as _telemetry
from .base import MXNetError
from .ndarray import NDArray
from .telemetry import numerics as _numerics
from .train_step import CAPTURE_WARMUP


def _state_leaves(state):
    """The NDArrays of one optimizer state (an NDArray, None, or a tuple)."""
    if isinstance(state, NDArray):
        return [state]
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _state_leaves(s)]
    return []


def _hyper_partition(lrs, wds):
    """Each parameter's group of equal (lr, wd), and the groups' values."""
    index, values, part = {}, [], []
    for pair in zip(lrs, wds):
        if pair not in index:
            index[pair] = len(values)
            values.append(pair)
        part.append(index[pair])
    return tuple(part), values


class FusedTrainStep:
    """Forward, backward and update of a Module's executor and optimizer
    as one step: one CUDA graph replay on the card."""

    def __init__(self, module):
        exec_ = module._exec
        self._module = module
        self._exec_ref = exec_
        self._opt_ref = module._optimizer
        self._arg_names = list(exec_._arg_names)
        self._aux_names = list(exec_._aux_names)
        self._train = [(i, n) for i, n in enumerate(module._param_names)
                       if exec_.grad_req.get(n, "null") == "write"]
        if not self._train:
            raise MXNetError("fused step: no trainable parameters")
        self._train_names = [n for _, n in self._train]
        self._opt_indices = [i for i, _ in self._train]
        self._train_set = set(self._train_names)
        self._device = exec_._device
        self._graph = None
        self._sig = None
        self._hyper = None          # the captured step's (lr, wd) device tensor
        self._hyper_values = None
        self._static_outs = ()
        self._owned = {}            # token of an array's place -> the graph's tensor
        self._static_stats = None
        self._pending = None        # the last step's stats, until observe() judges them
        self._stats_host = None     # pinned host copy of a replay's stats
        self._stats_event = None
        # the numerics observatory's frozen part: (mode, poison armed), the
        # buckets' labels and index tensor, the poison scalar
        self._num_sig = None
        self._num_mode = "off"
        self._num_poison = False
        self._num_labels = []
        self._num_index = None
        self._poison = None
        self._poison_value = None
        self.captures = 0
        self.replays = 0
        self.steps = 0

    # -- the step as a function of the module's tensors -----------------------
    def _states(self):
        updater = self._module._updater
        exec_ = self._module._exec
        for i, name in self._train:
            updater._ensure_state(i, exec_.arg_dict[name])
        return [updater.states[i] for i in self._opt_indices]

    def _arrays(self):
        """``[(token, NDArray)]`` of every array the step writes: weights,
        aux states, optimizer states and gradient arrays, each under a
        token of its place (name, or optimizer index and leaf)."""
        exec_ = self._module._exec
        out = [(("p", n), exec_.arg_dict[n]) for n in self._train_names]
        out += [(("a", n), exec_.aux_dict[n]) for n in self._aux_names]
        for i, state in zip(self._opt_indices, self._states()):
            out += [(("s", i, k), a) for k, a in enumerate(_state_leaves(state))]
        out += [(("g", n), exec_.grad_dict[n]) for n in self._train_names
                if n in exec_.grad_dict]
        return out

    def _micro(self, fn, exec_):
        """One forward and backward: ``(outputs, grads)``; the aux states
        take their new values in place."""
        args, leaves = [], []
        for n in self._arg_names:
            t = exec_.arg_dict[n]._data
            if n in self._train_set:
                t = t.detach().requires_grad_(True)
                leaves.append(t)
            args.append(t)
        aux = [exec_.aux_dict[n]._data for n in self._aux_names]
        with torch.enable_grad():
            outs, new_aux = fn(args, aux)
            pairs = [(o, torch.ones_like(o)) for o in outs if o.requires_grad]
            grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                        [c for _, c in pairs], allow_unused=True)
        with torch.no_grad():
            for a, new in zip(aux, new_aux):
                if new is not a:
                    a.copy_(new)
        grads = [torch.zeros_like(w) if g is None else g.to(w.dtype)
                 for g, w in zip(grads, leaves)]
        return tuple(o.detach() for o in outs), grads

    def _gated(self):
        """The tensors ``skip`` mode holds across an update: weights,
        optimizer-state leaves and aux states."""
        return [a._data for token, a in self._arrays() if token[0] != "g"]

    def _observe(self, grads, loss_outs):
        """The step's stat row and finite flag (the poison multiply first,
        when the chaos site is armed); ``(grads, None, None)`` when off."""
        if self._num_poison:
            grads = _numerics.poison_grads(grads, self._poison)
        if self._num_mode == "off":
            return grads, None, None
        row, finite = _numerics.trace_step(grads, loss_outs, self._num_index,
                                           len(self._num_labels))
        return grads, row, finite

    def _update(self, grads, states, lrs, wds):
        exec_ = self._module._exec
        weights = [exec_.arg_dict[n]._data for n in self._train_names]
        self._module._optimizer.fused_update(weights, grads, states, lrs, wds)
        zero = [exec_.grad_dict[n]._data for n in self._train_names if n in exec_.grad_dict]
        if zero:
            torch._foreach_zero_(zero)

    def _body(self, lrs, wds):
        """One step on the bound arrays; returns the outputs and the stat
        row (None when the observatory is off)."""
        exec_ = self._module._exec
        states = self._states()
        armed = self._num_mode != "off"
        weights = [exec_.arg_dict[n]._data for n in self._train_names]
        w0 = _numerics.copy_tensors(weights) if armed else None
        gate = _numerics.UpdateGate(self._gated()) if self._num_mode == "skip" else None
        outs, grads = self._micro(exec_._build_fn(True), exec_)
        grads, row, finite = self._observe(grads, [outs[0]] if outs else [])
        self._update(grads, states, lrs, wds)
        if gate is not None:
            gate.apply(finite)
        if armed:
            _numerics.window_param_stats(row, weights, w0)
        return outs, row

    # -- host side --------------------------------------------------------------
    def _feed(self, data_batch):
        """``{bound name: array}`` of the batch, or None when a shape is not
        the bound one (the caller runs the loop: a partial batch rebinds)."""
        module = self._module
        exec_ = module._exec
        feed = {}
        for desc, arr in zip(module._data_shapes, data_batch.data):
            feed[desc.name] = arr
        if module._label_shapes and data_batch.label:
            for desc, arr in zip(module._label_shapes, data_batch.label):
                feed[desc.name] = arr
        for name, arr in feed.items():
            bound = exec_.arg_dict.get(name)
            if bound is None or tuple(arr.shape) != tuple(bound.shape):
                return None
        return feed

    def _hyperparams(self, steps=None):
        opt = self._module._optimizer
        if steps is None:
            opt._update_count(list(self._opt_indices))
            return opt.fused_hyperparams(self._opt_indices)
        return opt.fused_window_hyperparams(self._opt_indices, steps)

    def _own(self):
        """Copy into the graph's buffers what was put in their arrays'
        place since the capture, and point the arrays at them again."""
        for token, arr in self._arrays():
            buf = self._owned[token]
            if arr._data is not buf:
                with torch.no_grad():
                    buf.copy_(arr._data)
                arr._data = buf
                arr._bump()

    def _signature(self, extra):
        opt = self._module._optimizer
        return (opt.fused_static_signature(), extra, self._num_sig,
                tuple((t, a.shape, a._data.dtype, a._data.device) for t, a in self._arrays()))

    def _numerics_plan(self):
        """Freeze the observatory's mode, whether the poison multiply is in
        the step, and the stat buckets (dtype-contiguous groups of the
        trainable parameters), for the runs until they change; then write
        this run's poison scalar (one ``train/poison_grad`` hit a run)."""
        mode = _numerics.trace_mode()
        sig = (mode, mode != "off" and _numerics.poison_armed())
        if sig != self._num_sig:
            self._num_sig = sig
            self._num_mode, self._num_poison = sig
            self._num_labels, self._num_index = [], None
            if mode != "off":
                arrays = [self._module._exec.arg_dict[n] for n in self._train_names]
                groups, self._num_labels = _numerics.stat_groups(
                    [a.shape for a in arrays], [a._data.dtype for a in arrays],
                    names=self._train_names)
                self._num_index = _numerics.bucket_index(groups, self._device)
            self._poison = torch.ones((), dtype=torch.float32, device=self._device) \
                if self._num_poison else None
            self._poison_value = 1.0
        if self._num_poison:
            value = _numerics.poison_value()
            if value != self._poison_value:
                if self._device.type == "cuda":
                    self._poison.copy_(torch.tensor(value).pin_memory(), non_blocking=True)
                else:
                    self._poison.fill_(value)
                self._poison_value = value

    def _capture(self, run, sig):
        """Capture ``run()`` (the step or the window) as a CUDA graph after
        the warm-up, putting every written tensor back afterwards."""
        self._graph = None          # free the old graph's memory first
        arrays = [a for _, a in self._arrays()]
        saved = [a._data.detach().clone() for a in arrays]
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(device=self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                run()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                outs, stats = run()
        except Exception as e:
            raise MXNetError(f"capture of the fused train step failed: {e}") from e
        with torch.no_grad():
            for a, s in zip(arrays, saved):
                a._data.copy_(s)
        self._graph, self._static_outs, self._sig = graph, outs, sig
        self._static_stats = stats
        self._owned = {t: a._data for t, a in self._arrays()}
        self.captures += 1

    def _write_hyper(self, values):
        """Write the (lr, wd) groups' values into the device tensor when
        they changed since the last replay."""
        if values != self._hyper_values:
            host = torch.tensor(values, dtype=torch.float32).pin_memory()
            self._hyper.copy_(host, non_blocking=True)
            self._hyper_values = values

    def _hyper_views(self, part, shape):
        """A device tensor of ``shape`` + (groups, 2) and, per step, each
        parameter's (lr, wd) as 0-d views of it."""
        self._hyper = torch.zeros(shape, device=self._device)
        self._hyper_values = None
        flat = self._hyper.reshape(-1, self._hyper.shape[-2], 2)
        views = []
        for k in range(flat.shape[0]):
            lr = [flat[k, g, 0] for g in range(flat.shape[1])]
            wd = [flat[k, g, 1] for g in range(flat.shape[1])]
            views.append(([lr[g] for g in part], [wd[g] for g in part]))
        return views

    def step(self, data_batch):
        """One fused step; False when the batch's shapes are not the bound
        ones (the caller runs the per-parameter loop, which rebinds).  With
        the observatory armed the step's stats are copied to the host without
        waiting, and ``observe()`` judges them (``Module.update``, or the next
        step's start)."""
        self.observe()
        feed = self._feed(data_batch)
        if feed is None:
            return False
        exec_ = self._module._exec
        for name, arr in feed.items():
            exec_.arg_dict[name]._write(arr._data if isinstance(arr, NDArray)
                                        else torch.as_tensor(arr))
        lrs, wds = self._hyperparams()
        self._numerics_plan()
        if self._device.type != "cuda":
            outs, stats = self._body(lrs, wds)
        else:
            part, values = _hyper_partition(lrs, wds)
            sig = self._signature(part)
            if self._graph is None or sig != self._sig:
                views = self._hyper_views(part, (len(values), 2))[0]
                self._write_hyper(values)
                self._capture(lambda: self._body(*views), sig)
            self._own()
            self._write_hyper(values)
            try:
                self._graph.replay()
            except RuntimeError as e:
                raise MXNetError(f"replay of the fused train step failed: {e}") from e
            self.replays += 1
            outs = [o.clone() for o in self._static_outs]
            stats = self._static_stats
        _prof.record_dispatch("fused_step")
        exec_.outputs = [NDArray(o) for o in outs]
        exec_._tape = None
        exec_._last_is_train = True
        self.steps += 1
        _prof.record_counter("train:fused_step_total", self.steps)
        if stats is not None:
            self._hold(stats)
        return True

    def _hold(self, stats):
        """Start the stats' copy to the host (pinned, not waited for) and keep
        it for ``observe``, so that the fit loop stages the next batch while
        the device runs this step."""
        event = None
        if stats.is_cuda:
            if self._stats_host is None or self._stats_host.shape != stats.shape:
                self._stats_host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
                self._stats_event = torch.cuda.Event()
            self._stats_host.copy_(stats, non_blocking=True)
            self._stats_event.record()
            stats, event = self._stats_host, self._stats_event
        self._pending = (stats, event, self.steps)

    def observe(self):
        """Judge the last step's stats, if it has not been judged: the
        boundary's one read, which waits for the step's copy of them.  Under
        ``MXNET_NUMERICS=halt`` a non-finite step raises ``NonFiniteError``
        here, with the outputs and arrays of that step in place."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        stats, event, step = pending
        if event is not None:
            # a wait for the device: the step timer's device_block, not the
            # step_dispatch lane it is called in
            timer = _telemetry.current_step_timer()
            t0 = time.perf_counter()
            event.synchronize()
            if timer.active:
                waited = time.perf_counter() - t0
                timer.add("device_block", waited)
                timer.add("step_dispatch", -waited)
        return _numerics.observe_window(stats, kind="fused_step", first_step=step, window=step,
                                        group_labels=self._num_labels)

    def stale(self, module):
        return module._exec is not self._exec_ref or module._optimizer is not self._opt_ref


class ScanTrainStep(FusedTrainStep):
    """K fused steps as one window, each over M micro-batches whose
    gradients are summed before one update (``MXNET_SCAN_STEPS``,
    ``MXNET_SCAN_ACCUM``): one CUDA graph replay a window on the card."""

    def __init__(self, module, scan_steps, accum=1):
        super().__init__(module)
        self.scan_steps = max(1, int(scan_steps))
        self.accum = max(1, int(accum))
        self._feeds = ()            # the captured window's stacked inputs
        self.windows = 0

    def _window(self, feeds, feed_names, hypers):
        """The window on the bound arrays: for each step its M
        micro-batches' data copied in, their gradients summed, one update.
        Returns each output stacked over the K x M micro-batches, and the
        window's ``(K, N_CORE + buckets)`` stat rows (None when the
        observatory is off)."""
        exec_ = self._module._exec
        states = self._states()
        fn = exec_._build_fn(True)
        armed = self._num_mode != "off"
        weights = [exec_.arg_dict[n]._data for n in self._train_names]
        stats = w0 = None
        if armed:
            w0 = _numerics.copy_tensors(weights)
            stats = torch.zeros((len(hypers), _numerics.N_CORE + len(self._num_labels)),
                                dtype=torch.float32, device=self._device)
        stacked = []
        for k, (lrs, wds) in enumerate(hypers):
            gate = _numerics.UpdateGate(self._gated()) if self._num_mode == "skip" else None
            grads_sum = None
            for m in range(self.accum):
                j = k * self.accum + m
                with torch.no_grad():
                    for name, f in zip(feed_names, feeds):
                        exec_.arg_dict[name]._data.copy_(f[j])
                outs, grads = self._micro(fn, exec_)
                stacked.append(outs)
                grads_sum = grads if grads_sum is None else \
                    [a + b for a, b in zip(grads_sum, grads)]
            loss_outs = [o[0] for o in stacked[-self.accum:]] if stacked[-1] else []
            grads_sum, row, finite = self._observe(grads_sum, loss_outs)
            if armed:
                stats[k].copy_(row)
            self._update(grads_sum, states, lrs, wds)
            if gate is not None:
                gate.apply(finite)
        if armed:
            _numerics.window_param_stats(stats, weights, w0)
        return tuple(torch.stack([o[i] for o in stacked]) for i in range(len(stacked[0]))), \
            stats

    def run_window(self, sbatch):
        """Run one window of a staged ``io.SuperBatch`` of K x M batches.
        Returns each output stacked over the micro-batches (leading dim
        K x M), or False when the window is short or its shapes are not the
        bound ones.  Under ``MXNET_NUMERICS=halt`` a non-finite window raises
        ``NonFiniteError`` after its outputs and arrays are in place."""
        module = self._module
        exec_ = module._exec
        K, M = self.scan_steps, self.accum
        W = K * M
        if sbatch.count != W:
            return False
        feed = {}
        for desc, arr in zip(module._data_shapes, sbatch.data):
            feed[desc.name] = arr
        if module._label_shapes and sbatch.label:
            for desc, arr in zip(module._label_shapes, sbatch.label):
                feed[desc.name] = arr
        for name, arr in feed.items():
            bound = exec_.arg_dict.get(name)
            if bound is None or tuple(arr.shape) != (W,) + tuple(bound.shape):
                return False
        names = sorted(feed)
        feeds = [feed[n].to(self._device, exec_.arg_dict[n]._data.dtype) for n in names]
        lrs, wds = self._hyperparams(steps=K)
        self._numerics_plan()
        if self._device.type != "cuda":
            outs, stats = self._window(feeds, names, list(zip(lrs, wds)))
        else:
            parts = [_hyper_partition(a, b) for a, b in zip(lrs, wds)]
            part = parts[0][0]
            if any(p != part for p, _ in parts):
                raise MXNetError("scanned window: the parameters' groups of equal learning "
                                 "rate and weight decay change inside the window")
            values = [v for _, v in parts]
            sig = self._signature((part, K, M, tuple((n, f.shape, f.dtype)
                                                      for n, f in zip(names, feeds))))
            if self._graph is None or sig != self._sig:
                views = self._hyper_views(part, (K, len(values[0]), 2))
                self._feeds = [f.clone() for f in feeds]
                self._write_hyper(values)
                self._capture(lambda: self._window(self._feeds, names, views), sig)
            self._own()
            with torch.no_grad():
                for buf, f in zip(self._feeds, feeds):
                    buf.copy_(f)
            self._write_hyper(values)
            try:
                self._graph.replay()
            except RuntimeError as e:
                raise MXNetError(f"replay of the scanned train window failed: {e}") from e
            self.replays += 1
            outs = [o.clone() for o in self._static_outs]
            stats = self._static_stats
        _prof.record_dispatch("scan_window")
        exec_.outputs = [NDArray(o[W - 1]) for o in outs]
        exec_._tape = None
        exec_._last_is_train = True
        self.steps += K
        self.windows += 1
        _prof.record_counter("train:fused_step_total", self.steps)
        if stats is not None:
            _numerics.observe_window(stats, kind="scan_window", first_step=self.steps - K + 1,
                                     window=self.windows, group_labels=self._num_labels)
        return list(outs)


__all__ = ["FusedTrainStep", "ScanTrainStep"]
