"""Telemetry of the PyTorch port (counterpart of ``mxnet_tpu/telemetry/``).

* **spans** (``span``, ``spans.py``): nestable, thread-safe timed regions
  that merge into the profiler's chrome trace, into its device trace as
  ``torch.profiler.record_function`` ranges, and into the
  ``mxnet_span_seconds`` histogram; one global check while disabled.
* **the step breakdown** (``steps.py``): ``Module.fit`` charges each
  train step's wall time to the ``LANES`` (``data_wait``, ``h2d_stage``,
  ``step_dispatch``, ``comm_collective``, ``device_block``,
  ``metric_flush``, ``ckpt_block``), read by ``step_breakdown()`` and
  logged by ``callback.StepTimeline``; ``mxnet_train_step_lane_seconds``
  and ``mxnet_train_step_seconds`` hold the per-step distributions.
* **the registry** (``REGISTRY``, ``registry.py``): counters, gauges,
  histograms and pull collectors behind one ``snapshot()`` and the
  Prometheus text of ``prometheus_dump()``.  The data plane records into
  ``mxnet_io_stage_seconds``, ``mxnet_io_stage_bytes_total``,
  ``mxnet_data_wait_seconds``, ``mxnet_data_queue_depth``,
  ``mxnet_data_batches_total``, ``mxnet_data_rebalance_total`` and
  ``mxnet_scan_window_steps``; the kvstore into
  ``mxnet_kvstore_bytes_total``/``_ops_total`` by ``op`` and
  ``mxnet_collective_*`` by ``kind``, each through its ``record_*``
  function.  The collectors: ``serving`` (``serving.metrics.stats()``,
  as ``mxnet_serving_*``), ``checkpoint`` (every live
  ``CheckpointManager``'s ``stats()``), ``profiler`` (dispatch counts and
  the last value of every counter lane), ``step`` (the breakdown's
  totals), ``trace`` (the exemplars), and, once their modules are
  imported, ``executor_cache`` and ``generation``.

``resources.LEDGER`` (device-buffer footprints), ``flight.record`` (the
ring of decision events) and ``trace`` (per-unit-of-work trace contexts)
serve the serving engines.  ``numerics`` is the numerics observatory: the
training statistics inside the fused step's and the scanned window's
graphs, their ``mxnet_numerics_*`` families and the ``numerics``
collector, and the serving output-health guard; ``numerics.configure()``
reads ``MXNET_NUMERICS`` at import.  ``MXNET_TELEMETRY`` arms the spans
and step lanes at import, and ``MXNET_TRACE`` the traces.  Still to port:
the exporter, the fleet plane, alerts, the watchdog and their collectors
(ROADMAP Queue A 11d).
"""
import sys
import weakref

from . import flight, numerics, resources, spans as _spans, steps as _steps, trace
from .registry import MetricsRegistry, exponential_buckets
from .spans import current_span, disable, enable, enabled, span, span_stack
from .steps import LANES, current_step_timer, reset_step_stats, step_breakdown, step_timer

#: the process-wide registry every subsystem reports into
REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
register_collector = REGISTRY.register_collector

_spans._span_hist = REGISTRY.histogram(
    "mxnet_span_seconds", "telemetry.span durations by span name")
_steps._lane_hist = REGISTRY.histogram(
    "mxnet_train_step_lane_seconds", "per-train-step time attributed to each breakdown lane")
_steps._step_hist = REGISTRY.histogram(
    "mxnet_train_step_seconds", "train step wall time (fit loop)")
trace._stage_hist = REGISTRY.histogram(
    "mxnet_trace_stage_seconds",
    "per-trace stage durations (end-to-end request/window tracing), by trace kind and "
    "stage name")
trace._e2e_hist = REGISTRY.histogram(
    "mxnet_trace_e2e_seconds", "end-to-end latency of finished traces, by trace kind")
_IO_STAGE = REGISTRY.histogram(
    "mxnet_io_stage_seconds",
    "host time spent staging a DataBatch host->device (io.stage_batch)")
_IO_STAGE_BYTES = REGISTRY.counter(
    "mxnet_io_stage_bytes_total", "bytes staged host->device by io")
_DATA_WAIT = REGISTRY.histogram(
    "mxnet_data_wait_seconds",
    "train-thread time blocked waiting on the streaming data plane "
    "(io_pipeline assembler/window feed); a rising _sum rate means training "
    "is data-bound")
_DATA_QUEUE_DEPTH = REGISTRY.gauge(
    "mxnet_data_queue_depth",
    "batches currently buffered in the streaming data plane (io_pipeline "
    "shard queues + window feed), by pipeline role")
_DATA_BATCHES = REGISTRY.counter(
    "mxnet_data_batches_total",
    "batches produced by streaming-data-plane reader workers (reader "
    "throughput; rate vs the fit loop's step rate says whether the readers "
    "keep up)")
_DATA_REBALANCE = REGISTRY.counter(
    "mxnet_data_rebalance_total",
    "shard rebalances after a reader worker died mid-epoch (remaining "
    "shards were requeued onto the survivors)")
_SCAN_WINDOW = REGISTRY.gauge(
    "mxnet_scan_window_steps",
    "train steps per scanned fit-window dispatch (MXNET_SCAN_STEPS; 1 = one "
    "dispatch per step)")
_SCAN_WINDOW.set(1)
_KV_BYTES = REGISTRY.counter(
    "mxnet_kvstore_bytes_total", "payload bytes moved through kvstore push/pull, by op")
_KV_OPS = REGISTRY.counter("mxnet_kvstore_ops_total", "kvstore push/pull calls, by op")
_COLLECTIVE_BYTES = REGISTRY.counter(
    "mxnet_collective_bytes_total",
    "logical payload bytes moved by gradient-synchronization collectives, by kind "
    "(kvstore_push/kvstore_pull for the per-parameter store path)")
_COLLECTIVE_SECONDS = REGISTRY.counter(
    "mxnet_collective_seconds",
    "seconds attributed to gradient-synchronization collectives, by kind")
_COLLECTIVE_OPS = REGISTRY.counter(
    "mxnet_collective_ops_total",
    "gradient-synchronization collective operations issued, by kind")


def record_kvstore(op, nbytes, n_ops=1):
    """Account one kvstore push or pull: its payload bytes and arrays."""
    labels = {"op": op}
    _KV_BYTES.inc(int(nbytes), labels=labels)
    _KV_OPS.inc(int(n_ops), labels=labels)


def record_collective(kind, nbytes, seconds=0.0, n=1):
    """Account gradient-synchronization collectives of ``kind``; the bytes
    come from shapes, never from a read of the device."""
    labels = {"kind": kind}
    _COLLECTIVE_BYTES.inc(int(nbytes), labels=labels)
    if seconds:
        _COLLECTIVE_SECONDS.inc(float(seconds), labels=labels)
    _COLLECTIVE_OPS.inc(int(n), labels=labels)


def record_io_stage(seconds, nbytes=0):
    """Account one staging of a batch or a window onto the device."""
    _IO_STAGE.observe(seconds)
    if nbytes:
        _IO_STAGE_BYTES.inc(int(nbytes))


def record_scan_window(steps):
    """Record the scanned window's size (``Module.fit``'s windows)."""
    _SCAN_WINDOW.set(int(steps))


def record_data_wait(seconds):
    """Account one blocking wait of the consumer on the data plane
    (``DataPipeline.next`` or ``WindowFeed.get``)."""
    _DATA_WAIT.observe(seconds)


def record_data_batches(n=1):
    """Account batches the reader workers produced."""
    _DATA_BATCHES.inc(int(n))


def record_data_queue_depth(depth, role="shards"):
    """Publish the buffered batches of one pipeline role (``shards``: the
    readers' queues, ``feed``: staged windows)."""
    _DATA_QUEUE_DEPTH.set(float(depth), labels={"role": role})


def record_data_rebalance(n=1):
    """Account one rebalance after a reader died."""
    _DATA_REBALANCE.inc(int(n))


# -- checkpoint managers (weakly held: managers come and go) -----------------
_ckpt_managers = weakref.WeakSet()


def register_checkpoint_manager(manager):
    """Called by ``CheckpointManager.__init__`` so that its ``stats()``
    joins the ``checkpoint`` collector; ``close()`` needs no unhook."""
    _ckpt_managers.add(manager)


def _checkpoint_snapshot():
    return {m.directory: m.stats() for m in list(_ckpt_managers)}


def _checkpoint_samples():
    renames = {"saves": "saves_total", "failures": "failures_total",
               "gc_removed": "gc_removed_total"}
    out = []
    for directory, stats in sorted(_checkpoint_snapshot().items()):
        labels = {"directory": directory}
        for key, value in sorted(stats.items()):
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            name = renames.get(key, key)
            mtype = "counter" if name.endswith("_total") else "gauge"
            out.append((f"mxnet_checkpoint_{name}", mtype,
                        f"CheckpointManager.stats() {key}", labels, value))
    return out


def _serving_snapshot():
    # pulled, never imported: a process that never served has no serving keys
    mod = sys.modules.get("mxnet_tpu_torch.serving.metrics")
    return mod.stats() if mod is not None else {}


def _serving_samples():
    out = []
    for name, snap in sorted(_serving_snapshot().items()):
        labels = {"server": name}
        lat = snap.get("latency_ms") or {}
        for q in ("p50", "p90", "p99"):
            if lat.get(q) is not None:
                out.append(("mxnet_serving_latency_ms", "gauge",
                            "serving request latency percentile",
                            {**labels, "quantile": q}, lat[q]))
        for key, value in sorted(snap.items()):
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            mtype = "counter" if key.endswith("_total") else "gauge"
            out.append((f"mxnet_serving_{key}", mtype, f"serving.stats() {key}", labels,
                        value))
    return out


def _profiler_snapshot():
    from .. import profiler
    return {"dispatch": profiler.dispatch_counts(), "counters": profiler.last_counters()}


def _profiler_samples():
    from .. import profiler
    out = [("mxnet_dispatch_total", "counter",
            "framework-issued calls (eager ops, executor passes, fused steps), by kind",
            {"kind": kind}, n) for kind, n in sorted(profiler.dispatch_counts().items())]
    for name, value in sorted(profiler.last_counters().items()):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            out.append(("mxnet_profiler_counter", "gauge",
                        "last value of each profiler counter lane", {"counter": name}, value))
    return out


def _step_samples():
    bd = _steps.step_breakdown()
    out = [("mxnet_train_steps_total", "counter",
            "fit-loop train steps timed by the step breakdown", {}, bd["steps"]),
           ("mxnet_train_step_wall_seconds_total", "counter",
            "total fit-loop step wall time", {}, bd["wall_s"]),
           ("mxnet_train_step_lane_seconds_total", "counter",
            "total step time attributed to each lane", {"lane": "other"}, bd["other_s"])]
    for lane, total in sorted(bd["lanes"].items()):
        out.append(("mxnet_train_step_lane_seconds_total", "counter",
                    "total step time attributed to each lane", {"lane": lane}, total))
    return out


REGISTRY.register_collector("serving", _serving_snapshot, _serving_samples)
REGISTRY.register_collector("checkpoint", _checkpoint_snapshot, _checkpoint_samples)
REGISTRY.register_collector("profiler", _profiler_snapshot, _profiler_samples)
REGISTRY.register_collector("step", _steps.step_breakdown, _step_samples)
REGISTRY.register_collector("trace", trace.exemplars)
REGISTRY.register_collector("numerics", numerics._collector_snapshot)


def snapshot():
    """Every metric family and collector, one dict."""
    return REGISTRY.snapshot()


def prometheus_dump():
    """The Prometheus text exposition of the registry."""
    return REGISTRY.prometheus_dump()


def _autostart():
    from .. import config as _config
    numerics.configure()
    if _config.get("MXNET_TELEMETRY"):
        enable()
    if _config.get("MXNET_TRACE"):
        trace.enable()


_autostart()


__all__ = ["LANES", "REGISTRY", "MetricsRegistry", "counter", "current_span",
           "current_step_timer", "disable", "enable", "enabled", "exponential_buckets", "flight",
           "gauge", "histogram", "numerics", "prometheus_dump", "record_collective",
           "record_data_batches", "record_data_queue_depth", "record_data_rebalance",
           "record_data_wait", "record_io_stage", "record_kvstore", "record_scan_window",
           "register_checkpoint_manager", "register_collector", "reset_step_stats",
           "resources", "snapshot", "span", "span_stack", "step_breakdown", "step_timer",
           "trace"]
