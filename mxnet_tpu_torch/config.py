"""Typed environment knobs of the PyTorch port (counterpart of
``mxnet_tpu/config.py``).

Only the knobs of the ported modules are registered, with the JAX
package's defaults and the same environment overrides: the generation
engine's six ``MXNET_GENERATION_*``, the SGD optimizer's
``MXNET_OPTIMIZER_AGGREGATION_SIZE``, Module's ``MXNET_FUSED_STEP``,
``MXNET_METRIC_SYNC_INTERVAL``, ``MXNET_SCAN_STEPS``, ``MXNET_SCAN_ACCUM``,
``MXNET_MODULE_PAD_PARTIAL_PREDICT`` and ``MXNET_FIT_STAGE_NEXT``, the numerics
observatory's ``MXNET_NUMERICS`` (``off``/``warn``/``skip``/``halt``),
``MXNET_NUMERICS_GRAD_NORM_MAX``, ``_HISTORY``, ``_DUMP_DIR`` and ``_SERVING``
with ``MXNET_COLLECTIVE_BUCKET_MB`` (its stat buckets), the dump directories'
``MXNET_FLIGHT_DIR``, ``MXNET_WATCHDOG_DIR`` and ``MXNET_WATCHDOG_KEEP``, the
profiler's ``MXNET_PROFILER_XPLANE_DIR``,
``MXNET_PROFILER_AUTOSTART`` and ``MXNET_PROFILER_MODE``, telemetry's
``MXNET_TELEMETRY``, ``MXNET_TRACE`` and ``MXNET_TRACE_SAMPLE``, ``parallel.spmd.TrainStep``'s
``MXNET_BACKWARD_DO_MIRROR``, the data plane's ``MXNET_DATA_WORKERS``,
``MXNET_DATA_QUEUE_DEPTH`` and ``MXNET_DATA_SHARD_SEED``, gluon.data's
``MXNET_MP_START_METHOD`` (``spawn`` or ``forkserver``; ``fork`` raises), the server's
eleven ``MXNET_SERVING_*``, the bucket ladder's ``MXNET_COMPILE_WARMUP``,
``MXNET_COMPILE_LADDER_MAX`` and ``MXNET_COMPILE_PLAN_MIN_SAMPLES``, and the
``BENCH_SERVE_*`` knobs of the serving measurement and ``BENCH_CKPT_MB`` of the
checkpoint measurement in ``chip_smoke.py``, and
the dist kvstore's: ``MXNET_KVSTORE_AUTH_TOKEN``, ``_ALLOW_INSECURE``,
``_MAX_FRAME``, ``_HEARTBEAT_INTERVAL``, ``_RETRIES``, ``_RETRY_BACKOFF_S``,
``_PEER_TIMEOUT_S``, ``_BIGARRAY_BOUND`` and the ``DMLC_*`` rendezvous keys,
and the checkpoint manager's seven ``MXNET_CKPT_*``.
``get`` reads the environment at each call, so a test's
``monkeypatch.setenv`` takes effect at once.
"""
from __future__ import annotations

import os
from collections import namedtuple

from .base import MXNetError

_Var = namedtuple("_Var", "name vtype default doc")
_REGISTRY = {}


def _register(name, vtype, default, doc):
    _REGISTRY[name] = _Var(name, vtype, default, doc)


def get(name):
    """Typed value of a registered knob (its default when unset)."""
    var = _REGISTRY.get(name)
    if var is None:
        raise MXNetError(f"unknown config variable {name!r}; see "
                         "mxnet_tpu_torch.config.list_vars()")
    raw = os.environ.get(name)
    if raw is None:
        return var.default
    try:
        if var.vtype is bool:
            low = raw.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off", ""):
                return False
            raise ValueError(raw)
        return var.vtype(raw)
    except (TypeError, ValueError) as e:
        raise MXNetError(f"config variable {name}={raw!r} is not a valid "
                         f"{var.vtype.__name__}") from e


def mp_start_method():
    """``MXNET_MP_START_METHOD``, checked: ``spawn`` or ``forkserver``."""
    method = get("MXNET_MP_START_METHOD")
    if method not in ("spawn", "forkserver"):
        raise MXNetError(f"MXNET_MP_START_METHOD={method!r}: the port's worker pools start "
                         "by 'spawn' or 'forkserver' (a forked child of a process that "
                         "holds a CUDA context cannot use CUDA)")
    return method


def list_vars():
    return sorted(_REGISTRY)


_register("MXNET_BACKWARD_DO_MIRROR", bool, False,
          "rematerialize forward activations during backward (memory for FLOPs; "
          "parity: gradient.cc mirror fn): TrainStep's torch.utils.checkpoint")
_register("MXNET_GENERATION_SLOTS", int, 8,
          "KV-cache slots per generation engine = concurrent sessions one "
          "fixed-shape decode micro-batch serves; a full pool sheds new "
          "sessions typed")
_register("MXNET_GENERATION_MAX_LEN", int, 512,
          "generation KV arena length cap (prompt + generated tokens per "
          "session; the decode step's fixed sequence dimension)")
_register("MXNET_GENERATION_PAGE_TOKENS", int, 64,
          "KV-cache page granularity in tokens: session reservations charge "
          "the resource ledger in whole pages, and the prefix cache "
          "stores/hits page-aligned prompt prefixes")
_register("MXNET_GENERATION_KV_BUDGET_MB", int, 64,
          "device-memory budget for one engine's committed KV pages; "
          "admission sheds typed (ServingOverloadError) rather than commit "
          "past it")
_register("MXNET_GENERATION_PREFIX_CACHE", int, 32,
          "prefix-cache capacity in entries (page-aligned prompt-prefix "
          "activations, LRU, content-hash keyed per model version); 0 "
          "disables prefix reuse")
_register("MXNET_GENERATION_LOOP_RESTARTS", int, 2,
          "how many times a crashed generation loop restarts (active "
          "sessions fail typed-retryable) before the engine fails fast; 0 = "
          "never restart")
_register("MXNET_OPTIMIZER_AGGREGATION_SIZE", int, 4,
          "weights per aggregated multi_sgd_* dispatch in the SGD "
          "optimizer (0 disables; parity: reference sgd.py)")
_register("MXNET_FUSED_STEP", bool, True,
          "Module train steps: forward, backward and the optimizer update "
          "as one fused step (one CUDA graph a step on the card) when the "
          "optimizer has fused_update; 0 runs the per-param update loop")
_register("MXNET_METRIC_SYNC_INTERVAL", int, 1,
          "Module.update_metric: feed buffered (label, output) pairs to the "
          "metric every N batches instead of reading the device every batch; "
          "1 = every batch. N>1 needs iterators that hand out fresh label "
          "arrays per batch (NDArrayIter and staged fit batches do)")
_register("MXNET_SCAN_STEPS", int, 1,
          "Module.fit: run this many fused train steps as one window (one "
          "CUDA graph replay on the card); metrics and callbacks run at "
          "window boundaries. 1 = one step at a time; needs the fused-step "
          "eligibility")
_register("MXNET_SCAN_ACCUM", int, 1,
          "gradient accumulation in a window: each step of the window takes "
          "this many micro-batches and applies one update over their summed "
          "gradients (Module's rescale_grad divides by the effective batch); "
          "1 disables")
_register("MXNET_MODULE_PAD_PARTIAL_PREDICT", bool, True,
          "Module.forward(is_train=False): pad a partial final batch up to "
          "the bound batch and slice the outputs, instead of binding a new "
          "executor shape")
_register("MXNET_FIT_STAGE_NEXT", bool, True,
          "fit loop: copy the next DataBatch to the module's device (pinned "
          "host memory, non-blocking) while the current step runs; 0 feeds "
          "batches at forward time")
_register("MXNET_DATA_WORKERS", int, 0,
          "streaming data plane: reader worker threads per DataPipeline "
          "(reads off the train thread) and the switch for the fit loop's "
          "off-thread window feed; 0 = serial in-thread reads (the same batch "
          "sequence, no overlap)")
_register("MXNET_DATA_QUEUE_DEPTH", int, 4,
          "streaming data plane: bounded per-shard output queue depth "
          "(batches); with the in-flight shard window it caps host memory: "
          "buffered batches <= depth x in-flight shards")
_register("MXNET_DATA_SHARD_SEED", int, 0,
          "streaming data plane: seed of the per-epoch shard order; the same "
          "order comes out for any worker count (docs/data.md)")
_register("MXNET_MP_START_METHOD", str, "forkserver",
          "multiprocessing start method of gluon.data.DataLoader's worker "
          "pools: forkserver or spawn; fork raises, since a forked child of "
          "a process that holds a CUDA context cannot use CUDA and inherits "
          "its threads' held locks")
_register("MXNET_NUMERICS", str, "off",
          "numerics observatory mode for the fused step and the scanned window: "
          "'off' (the boundary check is one global read), 'warn' (a flight event and "
          "a forensic dump on a non-finite or rule-breaching window; training "
          "continues), 'skip' (each poisoned step's update is also dropped on the "
          "device, inside the captured graph, so training continues bit for bit as a "
          "manual skip would), 'halt' (raise NonFiniteError at the boundary). The "
          "statistics (gradient and parameter norms, update ratio, loss proxy, "
          "non-finite counts by parameter bucket) are computed inside the step's CUDA "
          "graph: dispatches a step unchanged, weights bit for bit those of off")
_register("MXNET_NUMERICS_GRAD_NORM_MAX", float, 0.0,
          "numerics rule: a window whose global gradient L2 norm exceeds this is "
          "judged like a non-finite one (warn, skip-record or halt per "
          "MXNET_NUMERICS); 0 disables the rule")
_register("MXNET_NUMERICS_HISTORY", int, 512,
          "numerics observatory: per-step stat entries kept in the in-process "
          "history ring (forensic dumps embed it; numerics.monitor_summary() reads it)")
_register("MXNET_NUMERICS_DUMP_DIR", str, "",
          "directory of the mxnet-numerics-<pid>-<n>.json forensic dumps (empty: "
          "MXNET_FLIGHT_DIR, then MXNET_WATCHDOG_DIR, then the working directory); "
          "retention is MXNET_WATCHDOG_KEEP")
_register("MXNET_NUMERICS_SERVING", bool, True,
          "serving output-health guard: screen each executed batch's float outputs "
          "and fail the requests whose rows hold NaN or Inf with NonFiniteError "
          "(counted in mxnet_numerics_serving_nonfinite_total) instead of serving "
          "them; 0 disables the screen")
_register("MXNET_COLLECTIVE_BUCKET_MB", float, 4.0,
          "size bound of the numerics observatory's parameter buckets (dtype-"
          "contiguous groups of at most this many MB, the JAX package's collective "
          "buckets); the data-parallel TrainStep's own bucket_mb raises "
          "(ROADMAP Queue A 10b)")
_register("MXNET_FLIGHT_DIR", str, "",
          "directory of dump files (the numerics observatory's forensic dumps when "
          "MXNET_NUMERICS_DUMP_DIR is empty); empty: MXNET_WATCHDOG_DIR, then the "
          "working directory")
_register("MXNET_WATCHDOG_DIR", str, "",
          "fallback directory of dump files when MXNET_FLIGHT_DIR is empty (empty: "
          "the working directory)")
_register("MXNET_WATCHDOG_KEEP", int, 8,
          "retention of dump files in their directory: the newest N of each kind are "
          "kept, the oldest pruned at each new dump; 0 keeps everything")
# -- profiler and telemetry (mxnet_tpu/config.py:277-292,322,344,353) ---------
_register("MXNET_PROFILER_XPLANE_DIR", str, "",
          "directory of the profiler's device trace: start() opens a torch.profiler "
          "session (CPU and CUDA activity) and stop() writes its chrome trace there as "
          "mxnet-torch-trace-<pid>.json; empty disables the device trace")
_register("MXNET_PROFILER_AUTOSTART", bool, False,
          "start the profiler at import (parity: reference env_var.md "
          "MXNET_PROFILER_AUTOSTART)")
_register("MXNET_PROFILER_MODE", str, "",
          "with AUTOSTART: 'all'/'1' also enables profile_all + profile_api (parity: "
          "reference MXNET_PROFILER_MODE)")
_register("MXNET_TELEMETRY", bool, False,
          "enable the telemetry span tracer and the per-train-step lane breakdown "
          "(telemetry.span / callback.StepTimeline); the metrics registry and its "
          "collectors work regardless: this knob only arms the timed instrumentation")
_register("MXNET_TRACE", bool, False,
          "end-to-end tracing: a trace context (trace_id and stage spans) through every "
          "generation session and scanned training window; stage durations fan out to "
          "the span sinks and finished traces feed the sampled exemplar store; the "
          "disabled path is one global check")
_register("MXNET_TRACE_SAMPLE", str, "head=8,tail=64",
          "trace exemplar sampling policy per trace kind: keep the first `head` "
          "finished traces plus the `tail` slowest by end-to-end latency; exemplars "
          "surface in telemetry.snapshot()['trace']")
_register("MXNET_COMPILE_WARMUP", bool, True,
          "capture a model version's whole bucket ladder (one CUDA graph a "
          "bucket) through the repository's warm hooks before a hot-reloaded "
          "version serves; 0 leaves each bucket to its first request")
_register("MXNET_COMPILE_LADDER_MAX", int, 8,
          "bucket planner budget: most bucket boundaries a model's ladder may "
          "have (each boundary is one captured graph)")
_register("MXNET_COMPILE_PLAN_MIN_SAMPLES", int, 256,
          "formed batches to observe before the planner replaces the "
          "power-of-two ladder with one planned from the measured sizes")
# -- checkpoint --------------------------------------------------------------
_register("MXNET_CKPT_ASYNC", bool, True,
          "CheckpointManager: serialize and fsync on a background writer, so "
          "save() blocks the train loop only for the device->host snapshot; 0 "
          "makes every save synchronous")
_register("MXNET_CKPT_KEEP_LAST", int, 5,
          "retention: committed checkpoint steps kept (older steps are "
          "garbage-collected after each commit; 0 keeps everything)")
_register("MXNET_CKPT_KEEP_EVERY", int, 0,
          "retention: additionally keep every Nth step forever (step %% N == 0); "
          "0 disables")
_register("MXNET_CKPT_VERIFY_ON_LOAD", bool, True,
          "verify each file's sha256 on restore; a mismatch raises "
          "CheckpointCorruptError (a restore of the latest step falls back to "
          "the previous committed step)")
_register("MXNET_CKPT_WRITE_DELAY_MS", float, 0.0,
          "test/debug: sleep this long between tensor writes and before the "
          "manifest, widening the step-NNNNNN.tmp window for crash-during-save "
          "tests")
_register("MXNET_CKPT_WATCH_INTERVAL_S", float, 1.0,
          "serving ModelRepository.watch poll period for newly committed "
          "checkpoint steps")
_register("MXNET_CKPT_COMMIT_TIMEOUT_S", float, 60.0,
          "multi-host commit: how long host 0 waits for every host's shard "
          "manifest before failing the save")
_register("MXNET_SERVING_MAX_BATCH", int, 32,
          "DynamicBatcher flush size: a batch runs as soon as this many "
          "requests coalesce (the top of the bucket ladder)")
_register("MXNET_SERVING_MAX_LATENCY_MS", float, 5.0,
          "DynamicBatcher deadline: a partial batch flushes once its oldest "
          "request has waited this long (the throughput against p99 knob)")
_register("MXNET_SERVING_QUEUE_DEPTH", int, 256,
          "bounded serving queue capacity (requests)")
_register("MXNET_SERVING_SHED_WATERMARK", int, 0,
          "queue depth at which submits fail fast with ServingOverloadError; "
          "0 = at queue capacity")
_register("MXNET_SERVING_NUM_WORKERS", int, 1,
          "worker pipelines per batcher replica (each a stage and a dispatch "
          "thread: batch N+1 coalesces and stacks while batch N runs)")
_register("MXNET_SERVING_REPLICAS", int, 1,
          "DynamicBatcher replicas per model endpoint behind the ReplicaPool "
          "router (occupancy routing, spill, drain on removal); 1 = one batcher")
_register("MXNET_SERVING_SLO_P99_MS", float, 0.0,
          "SLO admission: shed (ServingOverloadError) once the router's "
          "predicted p99, pool occupancy over the service-rate EWMA, exceeds "
          "this many ms; 0 disables (the watermark still sheds per replica)")
_register("MXNET_SERVING_SLO_EWMA_ALPHA", float, 0.2,
          "smoothing factor of the admission controller's service-rate EWMA")
_register("MXNET_SERVING_TIMEOUT_MS", float, 0.0,
          "default per-request timeout (queued past it: RequestTimeoutError); "
          "0 disables")
_register("MXNET_SERVING_WORKER_RESTARTS", int, 8,
          "DynamicBatcher: restarts of a crashed worker thread (its batch fails "
          "with a retryable ServingWorkerError) before the batcher fails fast; "
          "0 = never restart")
_register("MXNET_SERVING_EXECUTOR_CACHE", int, 32,
          "LRU capacity of the executor cache, in (model, version, bucketed "
          "signature) entries, each one bound executor and, on the card, one "
          "CUDA graph")
_register("BENCH_CKPT_MB", int, 64,
          "checkpoint measurement (chip_smoke.py timing_checkpoint): size of the "
          "synthetic host state in MB")
_register("BENCH_SERVE_SECONDS", float, 8.0,
          "serving measurement: Poisson window (s)")
_register("BENCH_SERVE_RATE", float, 0.0,
          "serving measurement: Poisson arrival rate (req/s); 0 = 1.2x the "
          "closed-loop probe's throughput")
_register("BENCH_SERVE_BATCH", int, 32,
          "serving measurement: DynamicBatcher max_batch_size")
_register("BENCH_SERVE_LATENCY_MS", float, 10.0,
          "serving measurement: DynamicBatcher max_latency_ms")
# -- kvstore / distributed (mxnet_tpu/config.py:92-138) -----------------------
_register("MXNET_KVSTORE_AUTH_TOKEN", str, "",
          "HMAC key for dist kvstore frames (required for non-loopback binds)")
_register("MXNET_KVSTORE_ALLOW_INSECURE", bool, False,
          "allow a non-loopback kvstore bind without an auth token (trusted "
          "networks only)")
_register("MXNET_KVSTORE_MAX_FRAME", int, 1 << 30,
          "largest kvstore wire frame in bytes")
_register("MXNET_KVSTORE_HEARTBEAT_INTERVAL", float, 5.0,
          "worker heartbeat period in seconds (0 disables); feeds "
          "get_num_dead_node and the server's dead-peer monitor")
_register("MXNET_KVSTORE_RETRIES", int, 3,
          "retries of a kvstore client RPC after a transport failure "
          "(reconnect and resend with exponential backoff and jitter); 0 fails "
          "on the first error.  A sync push retried after a lost reply is "
          "at-least-once")
_register("MXNET_KVSTORE_RETRY_BACKOFF_S", float, 0.05,
          "base backoff of kvstore client retries; attempt i sleeps "
          "base * 2^i * (1 + jitter)")
_register("MXNET_KVSTORE_PEER_TIMEOUT_S", float, 30.0,
          "kvstore server dead-peer threshold: a rank that heartbeated once "
          "and then stays silent this long is lost, and every sync pull or "
          "barrier that needs it fails with PeerLostError")
_register("MXNET_KVSTORE_BIGARRAY_BOUND", int, 1000000,
          "arrays of more elements than this are pushed and pulled in row "
          "chunks under derived keys")
_register("DMLC_RANK", int, 0, "worker rank")
_register("DMLC_WORKER_ID", int, 0, "alias of DMLC_RANK")
_register("DMLC_NUM_WORKER", int, 1, "number of workers")
_register("DMLC_PS_ROOT_URI", str, "",
          "kvstore server host; empty: a dist store on one worker degrades to "
          "a local one")
_register("DMLC_PS_ROOT_PORT", int, 9091, "kvstore server port")
_register("DMLC_PS_BIND_ADDR", str, "127.0.0.1",
          "kvstore server bind address (loopback by default: frames are pickle)")
