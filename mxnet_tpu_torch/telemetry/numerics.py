"""The numerics observatory of the PyTorch port: training-health statistics
inside the captured train step, non-finite sentinels, forensic dumps, and
the serving output-health guard (counterpart of
``mxnet_tpu/telemetry/numerics.py``).

* **Statistics inside the step** (``trace_step``, ``window_param_stats``):
  the fused step and the scanned window (``fused_step.py``) compute, in the
  same function they capture as one CUDA graph, each step's global gradient
  L2 norm, its loss proxy (the f32 mean of the graph's primary output: the
  loss of a MakeLoss head, the mean probability of a SoftmaxOutput head),
  its non-finite count and the non-finite gradients of each parameter
  bucket (``stat_groups``: dtype-contiguous groups of at most
  ``MXNET_COLLECTIVE_BUCKET_MB``, so a bad bucket names a region of the
  model); and once a window the parameter norm, the update ratio
  ``|w_after - w_before| / |w_before|`` and the parameters' non-finite
  sentinel.  Per-array sums of squares come from one ``torch._foreach_norm``
  and the buckets from one ``index_add_``, so the launches a step adds do not
  grow with the number of parameters.  The rows land in an f32 tensor that
  the graph owns; the host reads it once, at the window boundary
  (``observe_window``).  Nothing inside the step reads the device.
* **Modes** (``MXNET_NUMERICS=off|warn|skip|halt``): ``warn`` only reads,
  so the weights stay bit for bit those of ``off``; ``skip`` gates each
  step's update on its own finite flag on the device (``UpdateGate``:
  ``torch.where(finite, new, old)`` over the weights, the optimizer
  states and the aux states, the dynamic loss scaler's idiom), so a
  poisoned step leaves everything as it was; ``halt`` raises a typed
  ``NonFiniteError`` at the boundary.  An attached ``amp.LossScaler``
  takes each step's flag from the boundary (``attach_loss_scaler``).
* **Forensics**: a non-finite or rule-breaching window (the rule is
  ``MXNET_NUMERICS_GRAD_NORM_MAX``) records a flight event and writes
  ``mxnet-numerics-<pid>-<n>.json`` atomically (``MXNET_NUMERICS_DUMP_DIR``,
  pruned to ``MXNET_WATCHDOG_KEEP``): the stats history, the window and
  step numbers, the non-finite counts by bucket, the random state, the
  last committed checkpoint step.  ``rng_key_path`` departs from the JAX
  package's key counter: it holds the port's seed (``mx.random.seed``)
  and, where torch exposes it, each device generator's offset, since the
  two packages' random streams never match.
* **Chaos**: the ``train/poison_grad`` failpoint (``poison_armed``,
  ``poison_value``) multiplies a window's gradients by NaN or Inf inside
  the graph; the multiply is captured only while the site is armed.
* **Serving guard** (``guard_rows``, ``MXNET_NUMERICS_SERVING``):
  non-finite rows of a batch fail their requests typed; they are counted in
  ``mxnet_numerics_serving_nonfinite_total`` by batcher
  (``serving_nonfinite()`` reads it).

The twelve ``mxnet_numerics_*`` families are the JAX package's; the
``numerics`` collector joins ``telemetry.snapshot()``.  Disarmed, the hot
path is one module-global check (``armed()``, the early-out of
``observe_window``).
"""
from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time

import numpy as np
import torch

from ..base import MXNetError, NonFiniteError
from . import flight

log = logging.getLogger("mxnet_tpu_torch.telemetry.numerics")

MODES = ("off", "warn", "skip", "halt")

#: names of the core stat slots; per-bucket non-finite counts follow
STAT_NAMES = ("grad_norm", "param_norm", "update_ratio", "loss", "nonfinite")
N_CORE = len(STAT_NAMES)

# module-global fast gates: the only thing a disarmed caller touches
_mode = "off"
_serving_guard = True

_lock = threading.Lock()
_history = collections.deque(maxlen=512)
_windows = 0
_dumps = 0
_scalers = []
_counts = {"steps": 0, "nonfinite_steps": 0, "nonfinite_windows": 0,
           "rule_breach_windows": 0, "skipped_updates": 0}
_families = None


# -- configuration ------------------------------------------------------------
def configure(mode=None, serving=None, history=None):
    """(Re)configure from the environment knobs; called at telemetry's
    import, and by tests that flip modes."""
    global _mode, _serving_guard, _history
    from .. import config as _config
    if mode is None:
        mode = str(_config.get("MXNET_NUMERICS") or "off").strip().lower()
    if mode not in MODES:
        raise MXNetError(f"MXNET_NUMERICS={mode!r}: expected one of {MODES}")
    if serving is None:
        serving = bool(_config.get("MXNET_NUMERICS_SERVING"))
    if history is None:
        history = int(_config.get("MXNET_NUMERICS_HISTORY"))
    with _lock:
        if history != _history.maxlen:
            _history = collections.deque(_history, maxlen=max(16, history))
    _serving_guard = bool(serving)
    _mode = mode
    if mode != "off":
        _metrics()
    return mode


def mode():
    return _mode


def armed():
    """True when the observatory watches train windows: one global read."""
    return _mode != "off"


def trace_mode():
    """The mode a captured step bakes in (part of its capture signature:
    arming or disarming captures anew, never drifts)."""
    return _mode


def serving_guard():
    """True when serving outputs are screened for non-finite rows."""
    return _serving_guard


def set_serving_guard(on):
    global _serving_guard
    _serving_guard = bool(on)


# -- registry families --------------------------------------------------------
def _metrics():
    global _families
    if _families is not None:
        return _families
    from . import REGISTRY
    _families = {
        "grad_norm": REGISTRY.gauge(
            "mxnet_numerics_grad_norm",
            "global L2 norm of the last observed step's gradients (computed in the "
            "captured step, read at window boundaries)"),
        "param_norm": REGISTRY.gauge(
            "mxnet_numerics_param_norm",
            "global L2 norm of the parameters after the last observed step's update"),
        "update_ratio": REGISTRY.gauge(
            "mxnet_numerics_update_ratio",
            "|param delta| / |params| of the last observed step (0 for a skipped "
            "update)"),
        "loss": REGISTRY.gauge(
            "mxnet_numerics_loss",
            "loss proxy of the last observed step: mean of the graph's primary "
            "output (the loss for MakeLoss/regression heads)"),
        "steps": REGISTRY.counter(
            "mxnet_numerics_steps_total",
            "train steps observed by the numerics observatory"),
        "nf_steps": REGISTRY.counter(
            "mxnet_numerics_nonfinite_steps_total",
            "observed train steps whose gradients/params/loss contained non-finite "
            "values"),
        "nf_windows": REGISTRY.counter(
            "mxnet_numerics_nonfinite_windows_total",
            "train windows containing at least one non-finite step"),
        "breaches": REGISTRY.counter(
            "mxnet_numerics_rule_breaches_total",
            "windows breaching a host-side numerics rule, by rule"),
        "skipped": REGISTRY.counter(
            "mxnet_numerics_skipped_updates_total",
            "poisoned per-step updates dropped on device by skip mode"),
        "nf_bucket": REGISTRY.counter(
            "mxnet_numerics_nonfinite_elements_total",
            "non-finite gradient elements observed, by parameter bucket"),
        "dumps": REGISTRY.counter(
            "mxnet_numerics_dumps_total",
            "forensic numerics dumps written"),
        "serving_nf": REGISTRY.counter(
            "mxnet_numerics_serving_nonfinite_total",
            "serving requests failed by the output-health guard (non-finite logits "
            "never served), by batcher"),
    }
    return _families


# -- buckets ------------------------------------------------------------------
_ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8, "int8": 1,
             "uint8": 1, "int32": 4, "int64": 8, "bool": 1}


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def stat_groups(shapes, dtypes, names=None, bucket_mb=None):
    """Group parameters (training order) into dtype-contiguous stat buckets
    of at most ``bucket_mb`` (``MXNET_COLLECTIVE_BUCKET_MB``) each, the JAX
    package's grouping rule.  Returns ``(groups, group_names)``: index
    lists and a display name a group."""
    if bucket_mb is None:
        from .. import config as _config
        bucket_mb = float(_config.get("MXNET_COLLECTIVE_BUCKET_MB"))
    limit = max(1, int(float(bucket_mb) * (1 << 20)))
    groups, cur, cur_bytes, cur_dtype = [], [], 0, None
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        name = _dtype_name(dtype)
        size = _ITEMSIZE.get(name) or np.dtype(name).itemsize
        nb = int(np.prod(shape, dtype=np.int64)) * size
        if cur and (name != cur_dtype or cur_bytes + nb > limit):
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dtype = name
    if cur:
        groups.append(cur)
    return groups, group_names(groups, names)


def group_names(groups, names=None):
    """Display name a group: its members' names joined, bounded in length."""
    out = []
    for g in groups:
        if names is None:
            out.append(f"params[{g[0]}..{g[-1]}]")
            continue
        label = "+".join(names[i] for i in g)
        out.append(label if len(label) <= 80 else f"{names[g[0]]}+..+{names[g[-1]]}")
    return out


def bucket_index(groups, device):
    """A long tensor mapping each parameter to its group, for the one
    ``index_add_`` that sums the per-array flags into buckets."""
    index = [0] * sum(len(g) for g in groups)
    for b, g in enumerate(groups):
        for i in g:
            index[i] = b
    return torch.tensor(index, dtype=torch.long, device=device)


# -- inside the step (no host read: these run inside a CUDA graph capture) ---
def _by_dtype(tensors):
    """``{dtype: positions}`` of a list, in first-seen order."""
    out = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def poison_grads(grads, poison):
    """Every gradient times the 0-d device scalar ``poison`` (1.0, an exact
    identity, unless the chaos site fired): one multi-tensor multiply a
    dtype."""
    out = list(grads)
    for dtype, pos in _by_dtype(grads).items():
        scale = poison if poison.dtype == dtype else poison.to(dtype)
        for i, g in zip(pos, torch._foreach_mul([grads[i] for i in pos], scale)):
            out[i] = g
    return out


def _sq_norms(tensors):
    """A (len,) f32 tensor of each array's sum of squares (one
    ``torch._foreach_norm`` in f32, squared)."""
    return torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float32)).square()


def trace_step(grads, loss_outs, index, n_groups):
    """One step's statistics inside the step: ``(row, finite)``.

    ``row`` is an f32 ``(N_CORE + n_groups,)`` tensor: the gradient L2
    norm, two zeros (the parameter side, filled once a window by
    ``window_param_stats``), the loss proxy (the f32 mean of
    ``loss_outs``, the primary output of each micro-batch), the non-finite
    count (arrays whose sum of squares is non-finite, plus one for a
    non-finite loss), then the non-finite arrays of each bucket.  A NaN or
    Inf element makes its array's sum of squares non-finite (the squares
    cannot cancel), so the per-array sentinel comes free with the norm; an
    overflowing but finite array reads as poisoned too, never as a miss.
    ``finite`` is a 0-d bool tensor: the step's gate in ``skip`` mode."""
    f32 = torch.float32
    sq = _sq_norms(grads)
    g_nf = (~torch.isfinite(sq)).to(f32)
    nf_groups = torch.zeros(n_groups, dtype=f32, device=sq.device).index_add_(0, index, g_nf)
    if loss_outs:
        loss = torch.stack(list(loss_outs)).to(f32).mean()
        nf_loss = (~torch.isfinite(loss)).to(f32)
    else:
        loss = torch.zeros((), dtype=f32, device=sq.device)
        nf_loss = loss
    total_nf = g_nf.sum() + nf_loss
    zero = torch.zeros((), dtype=f32, device=sq.device)
    row = torch.cat([torch.stack([sq.sum().sqrt(), zero, zero, loss, total_nf]), nf_groups])
    return row, total_nf == 0


def copy_tensors(tensors):
    """Copies of ``tensors`` by one multi-tensor copy (the window's start
    weights: the single carry copy of the JAX package's window)."""
    out = [torch.empty_like(t) for t in tensors]
    if out:
        torch._foreach_copy_(out, list(tensors))
    return out


def _views(flat, tensors):
    """``flat`` cut into views shaped as ``tensors``."""
    return [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _flat_copy(tensors):
    """One flat copy of same-dtype ``tensors`` (one multi-tensor copy into
    the views of a new buffer)."""
    flat = torch.empty(sum(t.numel() for t in tensors), dtype=tensors[0].dtype,
                       device=tensors[0].device)
    torch._foreach_copy_(_views(flat, tensors), list(tensors))
    return flat


class UpdateGate:
    """``skip`` mode's hold on the tensors a step writes: their values when
    the gate is made, in one flat buffer a dtype; ``apply(finite)`` writes
    back ``torch.where(finite, new, old)``, so a poisoned step leaves each
    tensor bit for bit as it was and a clean one keeps its update.  Each
    dtype costs two multi-tensor copies into a flat buffer, one ``where`` and
    one multi-tensor copy back, whatever the number of tensors."""

    def __init__(self, tensors):
        tensors = list(tensors)
        self._groups = []
        for _dtype, pos in _by_dtype(tensors).items():
            ts = [tensors[i] for i in pos]
            self._groups.append((ts, _flat_copy(ts)))

    def apply(self, finite):
        for ts, old in self._groups:
            new = _flat_copy(ts)
            torch.where(finite, new, old, out=new)
            torch._foreach_copy_(ts, _views(new, ts))


def _as_f32(tensors):
    return [t if t.dtype == torch.float32 else t.float() for t in tensors]


def window_param_stats(stats, new_params, old_params):
    """Fill the window's last stat row in place with the parameter side:
    the L2 norm of the parameters after the window, the window's update
    ratio ``|new - old| / (|old| + 1e-12)`` (0 when every update was
    skipped), and the parameters' non-finite sentinel added to the row's
    non-finite count.  ``stats`` is ``(n,)`` for one step or ``(K, n)``."""
    new32, old32 = _as_f32(new_params), _as_f32(old_params)
    n_sq = _sq_norms(new32).sum()
    u_sq = _sq_norms(torch._foreach_sub(new32, old32)).sum()
    o_sq = _sq_norms(old32).sum()
    last = stats if stats.dim() == 1 else stats[-1]
    last[1:3].copy_(torch.stack([n_sq.sqrt(), u_sq.sqrt() / (o_sq.sqrt() + 1e-12)]))
    last[4:5].add_((~torch.isfinite(n_sq)).to(torch.float32))
    return stats


# -- chaos --------------------------------------------------------------------
def poison_armed():
    """True while the chaos ``train/poison_grad`` site is armed: part of the
    capture signature, so the poison multiply exists only in chaos runs."""
    from ..chaos.failpoints import arms
    return "train/poison_grad" in arms()


def poison_value():
    """The host side of ``train/poison_grad``: the scalar every gradient of
    this window is multiplied by, 1.0 normally, NaN or Inf when the
    failpoint fires (``arm("train/poison_grad", "raise")`` for NaN, with
    ``value="inf"`` for Inf).  One call a window consumes one hit."""
    from ..chaos.failpoints import ChaosInjectedError, failpoint
    try:
        failpoint("train/poison_grad")
    except ChaosInjectedError as e:
        val = float("inf") if "'inf'" in str(e) else float("nan")
        log.warning("numerics: chaos poisoned this window's gradients with %s", val)
        return val
    return 1.0


# -- the fused overflow check (amp) -------------------------------------------
def host_all_finite(arrays):
    """One fused device reduction (``ops.optimizer.multi_all_finite``) and
    one host read: is every array all-finite?  ``None`` entries are
    skipped; NDArrays, tensors and numpy arrays are accepted."""
    from ..ops.optimizer import multi_all_finite
    bufs = [getattr(a, "_data", a) for a in arrays if a is not None]
    bufs = [b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
            for b in bufs]
    if not bufs:
        return True
    return bool(multi_all_finite(*bufs).item())


def attach_loss_scaler(scaler):
    """Feed an ``amp.LossScaler`` each observed step's flag at the window
    boundary: a poisoned step backs the scale off, clean steps feed its
    growth window, with no overflow check of its own."""
    with _lock:
        if scaler not in _scalers:
            _scalers.append(scaler)


def detach_loss_scaler(scaler):
    with _lock:
        if scaler in _scalers:
            _scalers.remove(scaler)


# -- the host boundary ---------------------------------------------------------
def observe_window(stats, kind, first_step, window, group_labels=(), nbatch=None):
    """Judge one window's stats at the host boundary.

    ``stats``: the window's stat rows, ``(n,)`` for a single fused step or
    ``(K, n)`` for a scanned window, a tensor (read here, the boundary's one
    small device read) or an array.  Updates the families and the history
    ring; a non-finite or rule-breaching window records a flight event and
    writes the forensic dump, attached loss scalers take the step flags,
    and in ``halt`` mode ``NonFiniteError`` is raised.  Returns the verdict
    dict (None when disarmed)."""
    if _mode == "off" or stats is None:
        return None
    if isinstance(stats, (tuple, list)) and not stats:
        return None
    from .. import config as _config
    if isinstance(stats, torch.Tensor):
        stats = stats.detach().to("cpu", torch.float64).numpy()
    arr = np.asarray(stats, np.float64)
    if arr.ndim == 1:
        arr = arr[None]
    K = arr.shape[0]
    gn_max = float(_config.get("MXNET_NUMERICS_GRAD_NORM_MAX"))
    m = _metrics()

    nf_col = arr[:, 4]
    core_bad = ~np.isfinite(arr[:, :N_CORE]).all(axis=1)
    nonfinite_steps = (nf_col > 0) | core_bad
    breach_steps = np.zeros(K, bool)
    if gn_max > 0:
        with np.errstate(invalid="ignore"):
            breach_steps = arr[:, 0] > gn_max
    n_nf = int(nonfinite_steps.sum())
    verdict = ("nonfinite" if n_nf else
               "rule_breach" if breach_steps.any() else "clean")

    last = arr[-1]
    m["grad_norm"].set(float(last[0]))
    m["param_norm"].set(float(last[1]))
    m["update_ratio"].set(float(last[2]))
    m["loss"].set(float(last[3]))
    m["steps"].inc(K)
    if n_nf:
        m["nf_steps"].inc(n_nf)
        m["nf_windows"].inc()
        if _mode == "skip":
            m["skipped"].inc(n_nf)
    if verdict == "rule_breach":
        m["breaches"].inc(labels={"rule": "grad_norm_max"})
    nf_by_group = _nonfinite_by_group(arr, group_labels)
    for label, n in nf_by_group.items():
        m["nf_bucket"].inc(int(n), labels={"bucket": label})

    global _windows
    entries = [{"step": int(first_step) + j, "kind": str(kind), "window": int(window),
                "grad_norm": float(arr[j, 0]), "param_norm": float(arr[j, 1]),
                "update_ratio": float(arr[j, 2]), "loss": float(arr[j, 3]),
                "nonfinite": float(arr[j, 4])} for j in range(K)]
    with _lock:
        _windows += 1
        _history.extend(entries)
        _counts["steps"] += K
        _counts["nonfinite_steps"] += n_nf
        if n_nf:
            _counts["nonfinite_windows"] += 1
            if _mode == "skip":
                _counts["skipped_updates"] += n_nf
        if verdict == "rule_breach":
            _counts["rule_breach_windows"] += 1
        scalers = list(_scalers)
    for scaler in scalers:
        for flag in nonfinite_steps:
            scaler.update_scale(bool(flag))

    result = {"verdict": verdict, "kind": str(kind), "window": int(window),
              "first_step": int(first_step), "steps": K, "nonfinite_steps": n_nf,
              "skipped": n_nf if (_mode == "skip" and n_nf) else 0}
    if verdict == "clean":
        return result

    bad = int(np.argmax(nonfinite_steps if n_nf else breach_steps))
    result.update({"bad_step": int(first_step) + bad, "grad_norm": float(arr[bad, 0]),
                   "loss": float(arr[bad, 3])})
    flight.record(
        "numerics", "nonfinite_window" if n_nf else "grad_norm_breach",
        severity="error", kind=kind, window=int(window), step=result["bad_step"],
        mode=_mode, grad_norm=float(arr[bad, 0]), loss=float(arr[bad, 3]),
        nonfinite=float(arr[bad, 4]),
        action=("skip" if _mode == "skip" else "halt" if _mode == "halt" else "warn"))
    dump_path = _dump_forensics(result, entries, nf_by_group, nbatch)
    result["dump"] = dump_path
    log.warning(
        "numerics: %s window %d (%s, step %d): grad_norm=%g loss=%g nonfinite=%g — %s%s",
        verdict, window, kind, result["bad_step"], arr[bad, 0], arr[bad, 3], arr[bad, 4],
        {"warn": "continuing (MXNET_NUMERICS=warn)",
         "skip": "poisoned update(s) dropped on device",
         "halt": "halting"}[_mode],
        f"; forensics: {dump_path}" if dump_path else "")
    if _mode == "halt":
        raise NonFiniteError(
            where=f"{kind} window {window}", step=result["bad_step"],
            stat="nonfinite" if n_nf else "grad_norm",
            value=float(arr[bad, 4] if n_nf else arr[bad, 0]),
            dump_path=dump_path,
            detail=f"grad_norm={arr[bad, 0]:g} loss={arr[bad, 3]:g}")
    return result


def _nonfinite_by_group(arr, group_labels):
    out = {}
    for g, label in enumerate(group_labels):
        col = N_CORE + g
        if col < arr.shape[1]:
            with np.errstate(invalid="ignore"):
                n = float(np.nan_to_num(arr[:, col], nan=0.0, posinf=0.0).sum())
            if n:
                out[label] = n
    return out


def _last_good_checkpoint_step():
    try:
        from . import _checkpoint_snapshot
        steps = [s.get("last_commit_step") for s in _checkpoint_snapshot().values()
                 if isinstance(s.get("last_commit_step"), (int, float))]
        return int(max(steps)) if steps else None
    except Exception as e:  # noqa: BLE001 - forensics enrichment only
        log.debug("numerics: checkpoint step lookup failed: %s", e)
        return None


def _rng_key_path():
    """What names the port's random stream: the seed and, where torch
    exposes it, each device generator's offset (a departure from the JAX
    package's key counter)."""
    from .. import random as _random
    offsets = {}
    for device, gen in list(_random._GENERATORS.items()):
        try:
            offsets[str(device)] = int(gen.get_offset())
        except RuntimeError:
            continue        # a CPU generator has no offset
    return {"seed": int(_random._SEED[0]), "offsets": offsets}


def _dump_dir():
    from .. import config as _config
    return _config.get("MXNET_NUMERICS_DUMP_DIR") or flight.dump_dir()


def _dump_forensics(result, window_entries, nf_by_group, nbatch):
    """Write ``mxnet-numerics-<pid>-<n>.json`` atomically; best-effort (the
    verdict, and a halt's raise, outrank the dump)."""
    global _dumps
    with _lock:
        _dumps += 1
        n = _dumps
        history_ = list(_history)
    directory = _dump_dir()
    path = os.path.join(directory, f"mxnet-numerics-{os.getpid()}-{n}.json")
    payload = {
        "pid": os.getpid(),
        "time": time.time(),
        "mode": _mode,
        "verdict": result["verdict"],
        "kind": result["kind"],
        "window": result["window"],
        "first_step": result["first_step"],
        "bad_step": result.get("bad_step"),
        "steps": result["steps"],
        "batch_index": nbatch,
        "rank": os.environ.get("MXNET_MULTIHOST_PROC_ID"),
        "rng_key_path": _rng_key_path(),
        "last_good_checkpoint_step": _last_good_checkpoint_step(),
        "nonfinite_by_bucket": nf_by_group,
        "window_stats": window_entries,
        "history": history_,
    }
    try:
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _metrics()["dumps"].inc()
        flight.prune(directory, "mxnet-numerics-")
        return path
    except OSError as e:
        log.error("numerics: forensic dump failed: %s", e)
        return None


# -- serving output guard -----------------------------------------------------
def guard_rows(outputs, n_rows):
    """Row indices (a set) of a batch whose float outputs hold non-finite
    values; ``outputs`` are host arrays led by the batch axis.  Empty when
    the guard is off."""
    if not _serving_guard:
        return ()
    bad = None
    for out in outputs:
        a = np.asarray(out)
        if a.dtype.kind != "f" or a.shape[:1] != (n_rows,):
            continue
        ok = np.isfinite(a.reshape(n_rows, -1)).all(axis=1)
        bad = ~ok if bad is None else (bad | ~ok)
    if bad is None or not bad.any():
        return ()
    return set(np.nonzero(bad)[0].tolist())


def record_serving_nonfinite(batcher, n=1):
    """Count guard-failed requests in ``mxnet_numerics_serving_nonfinite_total``
    and record the event in the flight ring."""
    _metrics()["serving_nf"].inc(int(n), labels={"batcher": str(batcher)})
    flight.record("numerics", "serving_nonfinite", severity="error",
                  batcher=batcher, requests=int(n))


def serving_nonfinite():
    """``{batcher: requests failed by the guard}``, read from the family."""
    return {e["labels"]["batcher"]: e["value"]
            for e in _metrics()["serving_nf"]._snapshot() if "batcher" in e["labels"]}


# -- read side ----------------------------------------------------------------
def history(last_n=None):
    """Recent per-step stat entries (oldest first)."""
    with _lock:
        entries = list(_history)
    return entries if last_n is None else entries[-int(last_n):]


def summary():
    """The counters and the gradient norm's spread over the history ring."""
    with _lock:
        counts = dict(_counts)
        windows = _windows
        gns = [e["grad_norm"] for e in _history if np.isfinite(e["grad_norm"])]
    out = {"mode": _mode, "windows": windows, **counts}
    if gns:
        out["grad_norm_last"] = gns[-1]
        out["grad_norm_max"] = float(max(gns))
        out["grad_norm_median"] = float(np.median(gns))
    return out


def monitor_summary(last_n=64):
    """``Monitor.toc()``-shaped rows ``[(step, stat_name, value_str)]`` from
    the history: the fused-compatible alternative to a ``Monitor``, which
    opts a Module out of the fused step (``monitor.py``)."""
    rows = []
    for entry in history(last_n):
        for stat in ("grad_norm", "param_norm", "update_ratio", "loss"):
            rows.append((entry["step"], stat, str(entry[stat])))
    return rows


def _collector_snapshot():
    snap = {"mode": _mode, "serving_guard": _serving_guard, "dumps": _dumps}
    snap.update(summary())
    return snap


def _reset_for_tests():
    """Disarm, clear the history and counters, detach scalers."""
    global _mode, _windows, _dumps
    with _lock:
        _history.clear()
        _scalers.clear()
        for k in _counts:
            _counts[k] = 0
        _windows = 0
        _dumps = 0
    _mode = "off"
