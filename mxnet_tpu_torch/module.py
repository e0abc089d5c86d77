"""The Module API of the PyTorch port: symbolic training (counterpart of
``mxnet_tpu/module.py``; parity: python/mxnet/module/ BaseModule.fit:409,
Module:364, BucketingModule, SequentialModule, PythonModule).

A Module binds its symbol once (``Symbol.simple_bind``) on its context
(``current_context()``, the card, unless the caller passes
``context=mx.cpu()``); ``forward``/``backward`` run the executor and
``update`` runs the optimizer's per-parameter loop.  When the setup is
eligible (``MXNET_FUSED_STEP``, an optimizer with ``fused_update``, no
monitor, ``grad_req`` write or null) ``forward_backward`` runs the fused
step of ``fused_step.py`` (one CUDA graph a step on the card) and the next
``update()`` only judges the step's numerics stats (when
``MXNET_NUMERICS`` is armed); ``_fused_step_done`` says whether the last
step was fused.  A fused step that fails raises: the JAX package's fall-back
to the loop for good (``module.py:1027-1045``) is not copied.  With
``MXNET_SCAN_STEPS``/``MXNET_SCAN_ACCUM`` a fit epoch runs K-step windows
(``fused_step.ScanTrainStep``), staged on a feed thread
(``io_pipeline.WindowFeed``) when ``MXNET_DATA_WORKERS`` > 0.  ``fit``
stages batch N+1 onto the device while step N runs
(``io.make_batch_stager``); ``MXNET_METRIC_SYNC_INTERVAL`` buffers the
metric's reads of the device; a partial final batch is padded on the
predict path (``MXNET_MODULE_PAD_PARTIAL_PREDICT``).

Stores and contexts, as the JAX Module has them (``module.py:547-551,
760-830``): a Module over a list of contexts runs on the first, where one
program covers the step; ``init_optimizer``'s store comes from
``model._create_kvstore``, so a store name over that one context makes no
store, and a ``KVStore`` object is used as given, with the optimizer in
the store: ``update`` then pushes every gradient and pulls every weight,
and the fused step stands aside.  ``compression_params`` arm such a
store's 2-bit compression.  A ``dist`` store name makes a store even
over one context, with the optimizer on its server; a string optimizer
then gets ``rescale_grad`` = 1 / (batch x ``num_workers``) for
``dist_sync`` and ``dist_device_sync`` (the server sums the workers'
pushes) and 1 / batch for ``dist_async`` (``module.py:764-800``).
``group2ctxs`` (a dict of group name to a context, or to a list of
contexts, one a device, or a list of such dicts; of each list the first is
used, as of ``context``) places the symbol's
``ctx_group`` nodes (``symbol/grouped.py``); such a Module runs the
per-parameter loop, not the fused step.  Not ported: the JAX package's
mesh-fused windows (``_fit_mesh``, ``_mesh_fused_eligible``,
``_demesh_arrays``; ROADMAP Queue A 10b).
``save_checkpoint(manager=)`` commits through a
``checkpoint.CheckpointManager`` (``save_module``), and a Module from
``CheckpointManager.restore_module`` gets its optimizer states at
``init_optimizer``.  Callbacks of a scanned window run after the whole
window, so a checkpoint a callback takes there holds the window's
boundary state.

``fit`` opens a ``telemetry.step_timer()`` (a no-op unless telemetry is
enabled) and closes it in ``finally``: each step's wall time goes to the
lanes ``data_wait``, ``h2d_stage`` and ``step_dispatch`` in the loop and in
the windows (the window feed's ``get()`` is ``data_wait``),
``comm_collective`` (the per-parameter store loop, moved out of
``step_dispatch``), and ``device_block`` and ``metric_flush`` in
``update_metric`` and ``flush_metric_updates``; a window is K x M steps.
On the card a fused step or a window is a CUDA graph replay, so its
``step_dispatch`` is the replay's launch and the device's work lands in
``device_block``, where the metric waits for the outputs.  Each window is
a ``train`` trace under ``MXNET_TRACE``.  Under ``MXNET_NUMERICS`` the
fused step and the window carry the numerics observatory inside their
graphs (``fused_step.py``), and a ``halt`` reaches the caller as
``NonFiniteError``.  A Module with a ``Monitor`` installed runs the
per-parameter loop (``monitor.py``).  The watchdog and the elastic
hooks of the JAX fit loop are left out (ROADMAP Queue A 11d, 10b), and so
are the mesh's calibrated share of ``comm_collective`` and the ambient
trace of a window (A 10b).
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from . import config as _config
from . import io as mx_io
from . import metric as metric_mod
from . import ndarray as nd
from . import optimizer as opt_mod
from . import profiler as _prof
from . import telemetry as _telemetry
from .base import MXNetError, NonFiniteError
from .context import as_context, current_context
from .initializer import InitDesc, Uniform
from .model import (BatchEndParam, _create_kvstore, _initialize_kvstore,
                    _update_params_on_kvstore, load_checkpoint, save_checkpoint)


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]


class BaseModule:
    """Base class of the Module API (parity: module/base_module.py)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    # -- high-level train and evaluation loops ----------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc", epoch_end_callback=None,
            batch_end_callback=None, kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),), eval_end_callback=None,
            eval_batch_end_callback=None, initializer=None, arg_params=None,
            aux_params=None, allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            sparse_row_id_fn=None):
        """Train the module (parity: base_module.py:409 fit)."""
        assert num_epoch is not None, "please specify number of epochs"
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data, label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        stager = mx_io.make_batch_stager(getattr(self, "_context", None))
        # the step-time lanes: a shared no-op unless telemetry is enabled
        timeline = _telemetry.step_timer()
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                plan = self._scan_plan()
                if plan is not None:
                    self._fit_epoch_scan(epoch, train_data, eval_metric, plan, stager,
                                         batch_end_callback, timeline)
                else:
                    self._fit_epoch_loop(epoch, train_data, eval_metric, monitor, stager,
                                         batch_end_callback, timeline)
                self.flush_metric_updates()
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
                arg_params, aux_params = self.get_params()
                self.set_params(arg_params, aux_params)
                if epoch_end_callback is not None:
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params, aux_params)
                if eval_data is not None:
                    res = self.score(eval_data, validation_metric,
                                     score_end_callback=eval_end_callback,
                                     batch_end_callback=eval_batch_end_callback, epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
                train_data.reset()
        finally:
            timeline.close()

    def _batch_end(self, batch_end_callback, epoch, nbatch, eval_metric, loc):
        if batch_end_callback is not None:
            params = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                                   locals=loc)
            for callback in _as_list(batch_end_callback):
                callback(params)

    def _fit_epoch_loop(self, epoch, train_data, eval_metric, monitor, stager,
                        batch_end_callback, timeline):
        """One epoch, one step a batch; with a stager, batch N+1 goes to the
        device while step N runs.  ``device_block`` and ``metric_flush`` are
        charged inside ``update_metric``, where the metric's read is."""
        nbatch = 0
        data_iter = iter(train_data)
        end_of_batch = False
        # the first step's wall holds the first batch's fetch, so that each
        # step's lanes lie inside its wall
        timeline.begin_step()
        with timeline.lane("data_wait"):
            next_data_batch = next(data_iter)
        if stager is not None:
            with timeline.lane("h2d_stage"):
                next_data_batch = stager(next_data_batch)
        while not end_of_batch:
            data_batch = next_data_batch
            if monitor is not None:
                monitor.tic()
            with timeline.lane("step_dispatch"):
                self.forward_backward(data_batch)
            fetched = None
            with timeline.lane("data_wait"):
                try:
                    fetched = next(data_iter)
                except StopIteration:
                    end_of_batch = True
            if fetched is not None:
                next_data_batch = fetched
                if stager is not None:
                    with timeline.lane("h2d_stage"):
                        next_data_batch = stager(fetched)
            with timeline.lane("step_dispatch"):
                self.update()
            self.update_metric(eval_metric, data_batch.label)
            if monitor is not None:
                monitor.toc_print()
            self._batch_end(batch_end_callback, epoch, nbatch, eval_metric, locals())
            nbatch += 1
            timeline.end_step()
        return nbatch

    def _scan_plan(self):
        """(K, M) when this epoch runs K-step windows of M micro-batches
        each, else None; only Module runs windows."""
        return None

    def _fit_epoch_scan(self, epoch, train_data, eval_metric, plan, stager,
                        batch_end_callback, timeline):
        """One epoch in windows: each run of K x M batches of the bound
        shapes is staged as one super-batch and runs as one window;
        metrics, callbacks and the step timer's accounting run at window
        boundaries (a window is K x M steps).  Batches that do not fill a
        window (the epoch's tail, another shape) run one by one.  When
        ``io_pipeline.feed_enabled()`` a ``WindowFeed`` thread collects and
        stages the windows, and the train thread waits only in its
        ``get()`` (the ``data_wait`` lane, ``mxnet_data_wait_seconds``).
        Each window is a ``train`` trace (``MXNET_TRACE``): collect, stage,
        dispatch, boundary_flush; a window that halts on a non-finite
        step (``MXNET_NUMERICS=halt``) records ``nonfinite_halt`` and finishes
        with status ``nonfinite``, and its ``NonFiniteError`` reaches the
        caller (nothing runs per batch in its place)."""
        from . import io_pipeline
        K, M = plan
        W = K * M
        ctx = getattr(self, "_context", None)
        data_iter = iter(train_data)
        nbatch = 0
        state = {"exhausted": False, "collect": None}
        _telemetry.record_scan_window(K)
        feed = io_pipeline.WindowFeed(data_iter, W, ctx, self._scan_batch_ok) \
            if io_pipeline.feed_enabled() else None

        def per_batch(batch):
            nonlocal nbatch
            if stager is not None:
                with timeline.lane("h2d_stage"):
                    batch = stager(batch)
            with timeline.lane("step_dispatch"):
                self.forward_backward(batch)
                self.update()
            self.update_metric(eval_metric, batch.label)
            self._batch_end(batch_end_callback, epoch, nbatch, eval_metric, locals())
            nbatch += 1
            timeline.end_step()

        def collect():
            """The next window's batches, the batches to run one by one after
            them, and the window as the feed staged it (else None)."""
            if feed is not None:
                with timeline.lane("data_wait"):
                    kind, batches, sbatch, span = feed.get()
                state["collect"] = span
                if kind == "end":
                    state["exhausted"] = True
                    return [], [], None
                return (batches, [], sbatch) if kind == "window" else ([], batches, None)
            t_c0 = time.perf_counter()
            batches, tail = [], []
            while len(batches) < W:
                with timeline.lane("data_wait"):
                    try:
                        b = next(data_iter)
                    except StopIteration:
                        state["exhausted"] = True
                        break
                if not self._scan_batch_ok(b):
                    tail.append(b)
                    break
                batches.append(b)
            state["collect"] = (t_c0, time.perf_counter())
            return batches, tail, None

        timeline.begin_step()
        try:
            while not state["exhausted"]:
                batches, tail, staged = collect()
                is_window = staged is not None if feed is not None else len(batches) == W
                outs = False
                wtrace = _telemetry.trace.NULL_TRACE
                if is_window:
                    wtrace = _telemetry.trace.start("train", "fit/window")
                    wtrace.add_stage("collect", *(state["collect"] or (wtrace.t0, wtrace.t0)))
                    sbatch = staged
                    if sbatch is None:
                        with timeline.lane("h2d_stage"), wtrace.stage("stage"):
                            sbatch = mx_io.stage_super_batch(batches, ctx)
                    try:
                        with timeline.lane("step_dispatch"), wtrace.stage("dispatch"):
                            outs = self._run_scan_window(sbatch, plan)
                    except NonFiniteError:
                        # MXNET_NUMERICS=halt is a verdict, not a failure of the
                        # window: it reaches the caller typed
                        wtrace.event("nonfinite_halt")
                        wtrace.finish(status="nonfinite")
                        raise
                    except BaseException as e:
                        wtrace.event("failed", cause=type(e).__name__)
                        wtrace.finish(status="error")
                        raise
                if outs is not False:
                    with wtrace.stage("boundary_flush"):
                        self._window_update_metrics(eval_metric, sbatch, outs)
                        for j in range(W):
                            self._batch_end(batch_end_callback, epoch, nbatch + j,
                                            eval_metric, locals())
                    wtrace.finish()
                    nbatch += W
                    timeline.end_step(steps=W)
                else:
                    wtrace.finish(status="fallback")
                    for b in batches:
                        per_batch(b)
                for b in tail:
                    per_batch(b)
        finally:
            if feed is not None:
                feed.close()
        return nbatch

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              score_end_callback=None, reset=True, epoch=0, sparse_row_id_fn=None):
        """Evaluate (parity: base_module.py score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            self._batch_end(batch_end_callback, epoch, nbatch, eval_metric, locals())
            actual_num_batch += 1
        self.flush_metric_updates()
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False, sparse_row_id_fn=None):
        """Run prediction and collect the outputs, the padding of a last
        batch sliced off (parity: base_module.py predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out.slice_axis(0, 0, out.shape[0] - (pad or 0))
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs
            output_list2 = [nd.concat(*[out[i] for out in output_list], dim=0)
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    # -- the interface subclasses implement --------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def bind(self, *args, **kwargs):
        raise NotImplementedError()

    def init_params(self, *args, **kwargs):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def flush_metric_updates(self):
        """Feed buffered metric updates (``MXNET_METRIC_SYNC_INTERVAL``); a
        no-op for modules that feed every batch."""

    def install_monitor(self, mon):
        raise NotImplementedError()


def _single_context(context):
    """One Context from ``context`` (None: ``current_context()``); of a
    list, the first, as the JAX Module takes it (``module.py:549``)."""
    if context is None:
        return current_context()
    if isinstance(context, (list, tuple)):
        context = context[0]
    return as_context(context)


class Module(BaseModule):
    """Module over ``(symbol, data_names, label_names)`` (parity:
    module/module.py:364), on one context."""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if isinstance(group2ctxs, (list, tuple)):
            group2ctxs = group2ctxs[0] if group2ctxs else None
        # upstream's form maps a group to one context a device: the first
        self._group2ctxs = {g: c[0] if isinstance(c, (list, tuple)) else c
                            for g, c in group2ctxs.items()} if group2ctxs else None
        self._compression_params = compression_params
        self._context = _single_context(context)
        self._symbol = symbol
        self._data_names = list(data_names) if data_names else []
        self._label_names = list(label_names) if label_names else []
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names + self._state_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._monitor = None
        self._fused = None
        self._fused_step_done = False
        self._scan = None
        self._scan_disabled = False
        self._pending_metric = []
        self._forward_pad = 0

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (parity: module.py load)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False, manager=None):
        """Save the symbol and the parameters, and the optimizer states
        with ``save_optimizer_states`` (parity: module.py
        save_checkpoint).  With ``manager`` (a
        ``checkpoint.CheckpointManager``) the save goes through it as step
        ``epoch`` (``save_module``); its ``legacy_prefix`` mirror, when
        set, also writes the ``prefix-NNNN.params`` files."""
        if manager is not None:
            return manager.save_module(self, epoch, save_optimizer_states=save_optimizer_states,
                                       epoch=epoch)
        self._sync_params_from_exec()
        save_checkpoint(prefix, epoch, self.symbol, self._arg_params, self._aux_params)
        if save_optimizer_states:
            states = self.get_optimizer_states()
            if states is not None:
                fname = f"{prefix}-{epoch:04d}.states"
                tmp = f"{fname}.tmp-{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(states)
                os.replace(tmp, fname)

    def get_optimizer_states(self, dump_optimizer=False):
        """The optimizer's states as bytes (None before any): the store's
        when it runs the optimizer."""
        if self._update_on_kvstore and self._kvstore is not None:
            return self._kvstore.get_optimizer_states(dump_optimizer)
        if self._updater is not None:
            return self._updater.get_states(dump_optimizer)
        return None

    def set_optimizer_states(self, states):
        """Install states of ``get_optimizer_states``; after
        ``init_optimizer``."""
        assert self.optimizer_initialized, \
            "call init_optimizer before restoring optimizer states"
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.set_optimizer_states(states)
        else:
            self._updater.set_states(states)

    # -- bind and parameters --------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        """Bind the executor (parity: module.py bind)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [_as_data_desc(x) for x in data_shapes]
        self._label_shapes = [_as_data_desc(x) for x in label_shapes] if label_shapes else []
        shape_kwargs = {d.name: d.shape for d in self._data_shapes}
        for l in self._label_shapes:
            shape_kwargs[l.name] = l.shape
        grad_req_dict = {}
        for name in self.symbol.list_arguments():
            if name in self._data_names:
                grad_req_dict[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or name in self._fixed_param_names \
                    or name in self._state_names or not for_training:
                grad_req_dict[name] = "null"
            else:
                grad_req_dict[name] = grad_req
        self._exec = self.symbol.simple_bind(self._context, grad_req=grad_req_dict,
                                             group2ctx=self._group2ctxs, **shape_kwargs)
        self._fused = None
        self._scan = None
        if self._arg_params is not None:
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Initialize the parameters (parity: module.py init_params): from
        ``arg_params``/``aux_params``, else from the loaded ones, else by
        ``initializer`` (Uniform(0.01) when None)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        for names, given, loaded, arrays in (
                (self._param_names, arg_params, self._arg_params, self._exec.arg_dict),
                (self._aux_names, aux_params, self._aux_params, self._exec.aux_dict)):
            for name in names:
                arr = arrays[name]
                if given is not None and name in given:
                    arr[:] = given[name]
                elif loaded is not None and name in loaded and not force_init:
                    arr[:] = loaded[name]
                else:
                    initializer(InitDesc(name), arr._data)
                    arr._bump()
        for name in self._state_names:
            self._exec.arg_dict[name][:] = 0
        self._sync_params_from_exec()
        self.params_initialized = True

    def set_states(self, states=None, value=None):
        """Set the states (parity: module.py set_states): ``states`` a list
        of NDArrays in ``state_names`` order, or ``value`` for every one."""
        assert self.binded and self._state_names
        if (states is None) == (value is None):
            raise MXNetError("set_states takes exactly one of states= or value=")
        if states is not None:
            if len(states) != len(self._state_names):
                raise MXNetError(f"set_states got {len(states)} arrays for "
                                 f"{len(self._state_names)} states {self._state_names}")
            for name, arr in zip(self._state_names, states):
                self._exec.arg_dict[name][:] = arr
        else:
            for name in self._state_names:
                self._exec.arg_dict[name][:] = value

    def get_states(self, merge_multi_context=True):
        assert self.binded and self._state_names
        return [self._exec.arg_dict[n].copy() for n in self._state_names]

    def get_params(self):
        """``(arg_params, aux_params)``: copies (parity: module.py
        get_params)."""
        assert self.binded and self.params_initialized
        self._sync_params_from_exec()
        return self._arg_params, self._aux_params

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True,
                   allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init,
                         allow_extra=allow_extra)

    def _sync_params_from_exec(self):
        if self._exec is None:
            return
        self._arg_params = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}

    # -- optimizer ----------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        """Install the optimizer and the store (parity: module.py
        init_optimizer; ``model._create_kvstore``).  A string optimizer
        gets ``rescale_grad`` = 1 / batch (x ``MXNET_SCAN_ACCUM``, and x
        the workers of a ``dist_sync`` or ``dist_device_sync`` store, whose
        server sums their pushes): the loss layers' gradients are batch
        sums."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        arg_params = {n: self._exec.arg_dict[n] for n in self._param_names}
        kv, update_on_kvstore = _create_kvstore(kvstore, 1, arg_params)
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            opt_kw = dict(optimizer_params or ())
            if "rescale_grad" not in opt_kw and self._data_shapes:
                batch = self._data_shapes[0][1][0]
                kv_type = kvstore if isinstance(kvstore, str) else getattr(kvstore, "type", "")
                if "dist" in (kv_type or "") and "_async" not in kv_type:
                    batch *= kv.num_workers if kv is not None else \
                        _config.get("DMLC_NUM_WORKER")
                batch *= max(1, int(_config.get("MXNET_SCAN_ACCUM")))
                if batch:
                    opt_kw["rescale_grad"] = 1.0 / batch
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name, **opt_kw)
        elif getattr(optimizer, "rescale_grad", 1.0) == 1.0 and \
                self._data_shapes and self._data_shapes[0][1][0] > 1:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad = 1.0. Is "
                "this intended? (gradients from loss layers are batch-summed; consider "
                "rescale_grad=1/batch_size)")
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self._fused = None
        self._scan = None
        self._scan_disabled = False
        self._kvstore = kv
        self._update_on_kvstore = bool(kv is not None and update_on_kvstore)
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            _initialize_kvstore(kv, [[arg_params[n]] for n in self._param_names],
                                arg_params, self._param_names, self._update_on_kvstore)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self.optimizer_initialized = True
        if hasattr(self, "_preload_opt_states"):
            with open(self._preload_opt_states, "rb") as f:
                self.set_optimizer_states(f.read())
            del self._preload_opt_states
        if hasattr(self, "_preload_opt_states_bytes"):
            # CheckpointManager.restore_module leaves the optimizer blob
            # here: it applies once the updater or the store exists
            self.set_optimizer_states(self._preload_opt_states_bytes)
            del self._preload_opt_states_bytes

    # -- compute ----------------------------------------------------------------------
    def _feed(self, data_batch):
        feed = {}
        for desc, arr in zip(self._data_shapes, data_batch.data):
            feed[desc.name] = arr
        if self._label_shapes and data_batch.label:
            for desc, arr in zip(self._label_shapes, data_batch.label):
                feed[desc.name] = arr
        return feed

    def forward(self, data_batch, is_train=None):
        """Forward on a batch (parity: module.py forward).  A batch of other
        shapes rebinds the executor (``reshape``), but a partial last batch
        in predict mode is padded to the bound batch."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._fused_step_done = False
        feed = self._feed(data_batch)
        self._forward_pad = 0
        mismatch = any(tuple(arr.shape) != tuple(self._exec.arg_dict[name].shape)
                       for name, arr in feed.items())
        if mismatch:
            pad = self._partial_batch_pad(feed) if not is_train else None
            if pad is not None:
                n, bound = pad
                self._forward_pad = bound - n
                self._pad_bound = bound
                self._pad_batch_outputs = self._infer_batch_outputs(feed, n, bound)
                for name, arr in feed.items():
                    host = arr.asnumpy() if hasattr(arr, "asnumpy") else np.asarray(arr)
                    host = np.concatenate([host, np.zeros((bound - n,) + host.shape[1:],
                                                          host.dtype)], axis=0)
                    self._exec.arg_dict[name][:] = host
                self._exec.forward(is_train=False)
                return
            self._exec = self._exec.reshape(partial_shaping=True, allow_up_sizing=True,
                                            **{n: a.shape for n, a in feed.items()})
        for name, arr in feed.items():
            self._exec.arg_dict[name][:] = arr
        self._exec.forward(is_train=is_train)

    def _partial_batch_pad(self, feed):
        """``(n, bound)`` when ``feed`` is the bound shapes short of a few
        batch rows, else None."""
        if not _config.get("MXNET_MODULE_PAD_PARTIAL_PREDICT"):
            return None
        ns, bounds = set(), set()
        for name, arr in feed.items():
            tgt = self._exec.arg_dict[name]
            if tuple(arr.shape[1:]) != tuple(tgt.shape[1:]):
                return None
            ns.add(int(arr.shape[0]))
            bounds.add(int(tgt.shape[0]))
        if len(ns) != 1 or len(bounds) != 1:
            return None
        n, bound = ns.pop(), bounds.pop()
        return (n, bound) if 0 < n < bound else None

    def _infer_batch_outputs(self, feed, n, bound):
        """The outputs whose leading dim is the batch, by shape inference at
        batches ``n`` and ``bound``; None when inference cannot tell."""
        cache = self.__dict__.setdefault("_batch_out_cache", {})
        key = (n, bound)
        if key not in cache:
            try:
                fixed = {name: tuple(a.shape) for name, a in self._exec.arg_dict.items()
                         if name not in feed}
                fixed.update({name: tuple(a.shape) for name, a in self._exec.aux_dict.items()})

                def outs_at(b):
                    shapes = dict(fixed)
                    shapes.update({name: (b,) + tuple(arr.shape[1:])
                                   for name, arr in feed.items()})
                    return self.symbol.infer_shape_partial(**shapes)[1]

                outs_n, outs_b = outs_at(n), outs_at(bound)
                if len(outs_n) == len(outs_b) and all(s is not None for s in outs_n + outs_b):
                    cache[key] = frozenset(
                        i for i, (sn, sb) in enumerate(zip(outs_n, outs_b))
                        if sn and sb and sn[0] == n and sb[0] == bound)
                else:
                    cache[key] = None
            except MXNetError as e:
                self.logger.debug("pad-slice output inference failed (%s); slicing "
                                  "every output of the bound batch", e)
                cache[key] = None
        return cache[key]

    def backward(self, out_grads=None):
        """Backward (parity: module.py backward)."""
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """Forward and backward; where the setup is eligible, the fused
        step instead (forward, backward and update at once), and the next
        ``update()`` does nothing."""
        if self._maybe_fused_step(data_batch):
            return
        self.forward(data_batch, is_train=True)
        self.backward()

    def _fused_eligible(self):
        if not _config.get("MXNET_FUSED_STEP"):
            return False
        if not (self.binded and self.params_initialized and self.optimizer_initialized
                and self.for_training):
            return False
        if self.inputs_need_grad or self._monitor is not None:
            return False
        if self._kvstore is not None:
            return False          # the gradients go through the store
        ex = self._exec
        if ex is None or ex._monitor_callback is not None or ex._grouped is not None:
            return False
        if not callable(getattr(self._optimizer, "fused_update", None)):
            return False
        if any(ex.grad_req.get(n, "null") not in ("write", "null") for n in ex._arg_names):
            return False
        return True

    def _maybe_fused_step(self, data_batch):
        """Run the fused step when eligible; False for the loop.  A failure
        raises (no fall-back to the loop)."""
        if not self._fused_eligible():
            return False
        from .fused_step import FusedTrainStep
        fs = self._fused
        if fs is None or fs.stale(self):
            fs = self._fused = FusedTrainStep(self)
        ran = fs.step(data_batch)
        if ran:
            self._fused_step_done = True
        return ran

    # -- windows of K steps (fused_step.ScanTrainStep) ---------------------------------
    def _scan_plan(self):
        if self._scan_disabled:
            return None
        K = max(1, int(_config.get("MXNET_SCAN_STEPS")))
        M = max(1, int(_config.get("MXNET_SCAN_ACCUM")))
        if K * M <= 1:
            return None
        if not self._fused_eligible():
            if M > 1:
                self.logger.warning("MXNET_SCAN_ACCUM=%d requested but the setup is not "
                                    "fused-step eligible; per-batch updates run WITHOUT "
                                    "gradient accumulation", M)
                self._scan_disabled = True
            return None
        return (K, M)

    def _scan_batch_ok(self, batch):
        """Whether every data and label array of ``batch`` has its bound
        shape (a partial tail or another bucket runs one by one)."""
        return all(tuple(arr.shape) == tuple(self._exec.arg_dict[name].shape)
                   for name, arr in self._feed(batch).items()
                   if name in self._exec.arg_dict)

    def _run_scan_window(self, sbatch, plan):
        """One staged super-batch through the window step; each output
        stacked over the window's batches, or False."""
        K, M = plan
        fs = self._scan
        if fs is None or fs.stale(self) or fs.scan_steps != K or fs.accum != M:
            from .fused_step import ScanTrainStep
            fs = self._scan = ScanTrainStep(self, K, M)
        outs = fs.run_window(sbatch)
        if outs is not False:
            self._forward_pad = 0
            self._fused_step_done = False
        return outs

    def update(self):
        """The optimizer's per-parameter loop over the gradients (parity:
        module.py update); after a fused step, only the judgment of its
        numerics stats (``FusedTrainStep.observe``)."""
        assert self.binded and self.params_initialized and self.optimizer_initialized
        if self._fused_step_done:
            self._fused_step_done = False
            # the step's numerics stats are judged here, after the fit loop
            # staged the next batch (MXNET_NUMERICS=halt raises)
            self._fused.observe()
            return
        if self._kvstore is not None and self._update_on_kvstore:
            # the per-parameter store loop's wall time is gradient
            # communication: it moves from step_dispatch to comm_collective
            st = _telemetry.current_step_timer()
            t0 = time.perf_counter()
            _update_params_on_kvstore(
                [[self._exec.arg_dict[n]] for n in self._param_names],
                [[self._exec.grad_dict.get(n)
                  if self._exec.grad_req.get(n, "null") != "null" else None]
                 for n in self._param_names],
                self._kvstore, self._param_names)
            if st.active:
                dt = time.perf_counter() - t0
                st.add("comm_collective", dt)
                st.add("step_dispatch", -dt)
            self._zero_grads()
            return
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None or self._exec.grad_req.get(name, "null") == "null":
                continue
            self._updater(i, grad, self._exec.arg_dict[name])
        self._zero_grads()

    def _zero_grads(self):
        """The gradient arrays read zeros after an update, as the JAX
        package leaves them (one fused launch)."""
        grads = [self._exec.grad_dict[n]._data for n in self._param_names
                 if n in self._exec.grad_dict and
                 self._exec.grad_req.get(n, "null") != "null"]
        if grads:
            with torch.no_grad():
                torch._foreach_zero_(grads)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        outs = self._exec.outputs
        pad = self._forward_pad
        if pad:
            bound = self._pad_bound
            batch_outs = self._pad_batch_outputs
            if batch_outs is not None:
                outs = [o.slice_axis(0, 0, bound - pad) if i in batch_outs else o
                        for i, o in enumerate(outs)]
            else:
                outs = [o.slice_axis(0, 0, bound - pad)
                        if len(o.shape) >= 1 and o.shape[0] == bound else o for o in outs]
        return outs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """Feed (labels, outputs) to the metric, which reads the device;
        with ``MXNET_METRIC_SYNC_INTERVAL`` = N the pairs are buffered and
        fed every N batches."""
        label_map = dict(zip([d.name for d in self._label_shapes], labels))
        pred_map = dict(zip(self.output_names, self.get_outputs()))
        if _config.get("MXNET_METRIC_SYNC_INTERVAL") <= 1:
            st = _telemetry.current_step_timer()
            if st.active:
                # the fit loop's lanes split where the wait is: device_block
                # for the step's outputs, metric_flush for the host math
                with st.lane("device_block"):
                    _prof.sync_devices([*label_map.values(), *pred_map.values()])
            with st.lane("metric_flush"):
                eval_metric.update_dict(label_map, pred_map)
            return
        self._pending_metric.append((eval_metric, label_map, pred_map, 1))
        if self._pending_metric_steps() >= _config.get("MXNET_METRIC_SYNC_INTERVAL"):
            self.flush_metric_updates()

    def _pending_metric_steps(self):
        return sum(entry[3] for entry in self._pending_metric)

    def _window_update_metrics(self, eval_metric, sbatch, outs):
        """Queue one window's labels and outputs, stacked; fed at once when
        the sync interval is 1, else once the buffer reaches it."""
        label_map = {}
        if self._label_shapes and sbatch.label:
            label_map = {d.name: nd.NDArray(l) for d, l in zip(self._label_shapes,
                                                               sbatch.label)}
        pred_map = {name: nd.NDArray(o) for name, o in zip(self.output_names, outs)}
        self._pending_metric.append((eval_metric, label_map, pred_map, sbatch.count))
        interval = _config.get("MXNET_METRIC_SYNC_INTERVAL")
        if interval <= 1 or self._pending_metric_steps() >= interval:
            self.flush_metric_updates()

    def flush_metric_updates(self):
        """Feed every buffered metric update: one host copy a stacked tensor,
        then the metric step by step."""
        pending, self._pending_metric = self._pending_metric, []
        if not pending:
            return
        st = _telemetry.current_step_timer()
        if st.active:
            with st.lane("device_block"):
                _prof.sync_devices([a for _metric, label_map, pred_map, _n in pending
                                    for a in (*label_map.values(), *pred_map.values())])
        with st.lane("metric_flush"):
            for metric, label_map, pred_map, n in pending:
                if n == 1:
                    metric.update_dict(label_map, pred_map)
                    continue
                lm = {k: v.asnumpy() for k, v in label_map.items()}
                pm = {k: v.asnumpy() for k, v in pred_map.items()}
                for j in range(n):
                    metric.update_dict({k: v[j] for k, v in lm.items()},
                                       {k: v[j] for k, v in pm.items()})

    @property
    def output_names(self):
        return self.symbol.list_outputs()

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def output_shapes(self):
        if self._exec is not None and self._exec.outputs:
            return [(n, o.shape) for n, o in zip(self.output_names, self._exec.outputs)]
        known = {d.name: d.shape for d in (self._data_shapes or [])}
        for l in (self._label_shapes or []):
            known[l.name] = l.shape
        _, outs, _ = self.symbol.infer_shape_partial(**known)
        return list(zip(self.output_names, outs or []))

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        mon.install(self._exec)


class BucketingModule(BaseModule):
    """One Module a bucket key over shared parameters (parity:
    module/bucketing_module.py)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None, state_names=None,
                 group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = _single_context(context)
        self._fixed_param_names = fixed_param_names
        self._state_names = list(state_names or [])
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._initializer = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        if bucket_key in self._buckets:
            return self._buckets[bucket_key]
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names, label_names, logger=self.logger,
                     context=self._context, fixed_param_names=self._fixed_param_names,
                     state_names=self._state_names)
        self._buckets[bucket_key] = mod
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        assert shared_module is None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad, force_rebind,
                 None, grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch to a bucket's module, carrying the parameters and the
        optimizer over (parity: bucketing_module.py switch_bucket)."""
        assert self.binded
        if bucket_key == self._curr_bucket_key:
            return
        arg_params, aux_params = self._curr_module.get_params() \
            if self._curr_module.params_initialized else (None, None)
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training, self.inputs_need_grad)
        if arg_params is not None and not mod.params_initialized:
            mod.init_params(self._initializer, arg_params=arg_params, aux_params=aux_params,
                            allow_missing=False)
        elif arg_params is not None:
            mod.set_params(arg_params, aux_params)
        if self.optimizer_initialized and not mod.optimizer_initialized:
            mod._optimizer = self._curr_module._optimizer
            mod._updater = self._curr_module._updater
            mod._kvstore = self._curr_module._kvstore
            mod._update_on_kvstore = self._curr_module._update_on_kvstore
            mod.optimizer_initialized = True
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if initializer is None:
            initializer = Uniform(0.01)
        self._initializer = initializer
        self._curr_module.init_params(initializer, arg_params, aux_params, allow_missing,
                                      force_init, allow_extra)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True,
                   allow_extra=False):
        self._curr_module.set_params(arg_params, aux_params, allow_missing, force_init,
                                     allow_extra)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params, force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        self.switch_bucket(bucket_key, data_batch.provide_data, data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)


class SequentialModule(BaseModule):
    """A chain of modules, each fed the previous one's outputs (parity:
    module/sequential_module.py)."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        my_data_shapes = data_shapes
        for i, module in enumerate(self._modules):
            meta = self._metas[i]
            my_label_shapes = label_shapes if meta.get(self.META_TAKE_LABELS) else None
            module.bind(my_data_shapes, my_label_shapes, for_training,
                        inputs_need_grad if i == 0 else True, force_rebind, None, grad_req)
            my_data_shapes = [mx_io.DataDesc(name, shape)
                              for name, shape in module.output_shapes]
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        for module in self._modules:
            module.init_params(initializer, arg_params, aux_params, allow_missing=True,
                               force_init=force_init)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        for module in self._modules:
            module.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for module in self._modules:
            module.forward(batch, is_train)
            batch = mx_io.DataBatch(data=module.get_outputs(), label=data_batch.label,
                                    pad=data_batch.pad)
        self._last_batch = batch

    def backward(self, out_grads=None):
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads)
            if i > 0:
                out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels, pre_sliced)


def _as_data_desc(x):
    if isinstance(x, mx_io.DataDesc):
        return x
    return mx_io.DataDesc(x[0], tuple(x[1]))


class PythonModule(BaseModule):
    """A module computed in Python, without a symbol or parameters
    (parity: module/python_module.py PythonModule): subclasses write
    ``forward``/``backward`` and ``_compute_output_shapes``."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = tuple(data_names)
        self._label_names = tuple(label_names or ())
        self._output_names = tuple(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [_as_data_desc(x) for x in data_shapes]
        self._label_shapes = [_as_data_desc(x) for x in label_shapes] if label_shapes \
            else None
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """``[(name, shape)]`` of the outputs: the subclass's."""
        raise NotImplementedError()

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        self.optimizer_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is not None:
            with _telemetry.current_step_timer().lane("metric_flush"):
                eval_metric.update(labels, self.get_outputs())


class PythonLossModule(PythonModule):
    """A loss head in Python (parity: module/python_module.py
    PythonLossModule): ``forward`` keeps the scores, ``backward`` takes
    their gradient from ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",), label_names=("softmax_label",),
                 logger=logging, grad_func=None):
        super().__init__([name + "_" + d for d in data_names], label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "PythonLossModule is a loss head; it accepts no head grads"
        if self._grad_func is None:
            raise NotImplementedError("PythonLossModule requires grad_func (the gradient "
                                      "of the loss with respect to the scores)")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]


__all__ = ["BaseModule", "BucketingModule", "Module", "PythonLossModule", "PythonModule",
           "SequentialModule"]
