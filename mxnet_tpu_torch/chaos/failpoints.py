"""Named, deterministic fault-injection sites (counterpart of
``mxnet_tpu/chaos/failpoints.py``, as far as the generation engine, the
server, the data plane, the kvstore, the checkpoint writer and the numerics
observatory need).

A hot path calls ``failpoint("serving/generation/decode")``; with nothing
armed (the default) that is one global check.  ``arm(site, "raise", hits,
count)`` makes the site raise ``ChaosInjectedError`` (or the builtin
exception named by ``value``, e.g. ``"OSError"``; another ``value`` is
named in the error's message, as ``train/poison_grad``'s ``"inf"`` is) from
its ``hits``-th call on, at most ``count`` times; ``arms()`` lists what is
armed and ``reset`` disarms everything.  A site that
produces bytes passes them through ``failpoint_bytes``, where a
``corrupt`` arm flips about 1 % of them (at least one) at positions drawn
from a stream seeded by the site's name, or with ``value="truncate"`` cuts
them to half; ``corrupt`` armed on a site without bytes raises.  Not
ported: the ``delay``, ``wedge`` and ``kill`` actions, probabilistic arms,
``MXNET_CHAOS`` spec strings and the injection counter (ROADMAP Queue
A 11d).
"""
from __future__ import annotations

import builtins
import logging
import random
import threading
import zlib

from ..base import MXNetError
from ..telemetry import flight

log = logging.getLogger("mxnet_tpu_torch.chaos")

ACTIONS = ("raise", "corrupt")

SITES = {
    "checkpoint/writer/pre_tmp_write":
        "background writer, before any byte of step-NNNNNN.tmp is written",
    "checkpoint/writer/post_tmp_write":
        "background writer, after the data file is written and fsynced, before "
        "the manifest",
    "checkpoint/writer/manifest":
        "bytes hook on the serialized MANIFEST.json (corrupt exercises the "
        "checksum and verify path)",
    "checkpoint/writer/pre_rename":
        "background writer, immediately before the atomic commit rename",
    "checkpoint/gc/remove":
        "retention GC, before each old step directory is removed",
    "serving/repository/poll":
        "ModelRepository.poll_checkpoint, before the committed-step scan",
    "serving/generation/decode":
        "generation engine loop, before the fixed-shape decode dispatch "
        "(raise kills the loop: active sessions fail typed-retryable, slots "
        "and ledger pages release)",
    "serving/batcher/submit":
        "DynamicBatcher.submit, after validation and before the queue (raise "
        "fails that submit alone)",
    "serving/batcher/worker":
        "batch dispatch thread, before the runner (raise kills the worker: its "
        "batch fails typed-retryable and the worker restarts in place)",
    "serving/router/dispatch":
        "ReplicaPool routing, before the chosen replica's submit (raise spills "
        "the request to the next replica)",
    "serving/repository/warm_hook":
        "ModelRepository, before each warm hook (raise skips that hook; the "
        "flip still happens)",
    "io/reader/read":
        "io_pipeline reader loop, before each batch is queued (raise kills that "
        "reader: its shard is given back and the other readers take its work)",
    "io/stage":
        "io.stage_batch and io.stage_super_batch, before a batch or a window is "
        "copied to the device (raise fails that staging)",
    "kvstore/client/rpc":
        "KVClient, before each frame of an RPC is sent (raise fails that RPC)",
    "kvstore/server/heartbeat":
        "KVServer, on each heartbeat (raise drops that heartbeat's connection)",
    "serving/executor_cache/capture":
        "CachedExecutor, inside a bucket's CUDA-graph capture (raise fails the "
        "capture: the batch fails typed, and nothing runs in its place)",
    "train/poison_grad":
        "numerics observatory injection: a raise arm poisons this window's "
        "gradients with NaN inside the captured step (raise with value 'inf' "
        "injects Inf); armed only while MXNET_NUMERICS watches, it proves the "
        "non-finite detection and the forensic dump end to end",
}

_any_armed = False
_lock = threading.Lock()
_arms = {}   # site -> _Arm


class ChaosInjectedError(MXNetError):
    """The typed error a ``raise`` arm injects; ``retryable`` models a
    transient fault."""

    retryable = True

    def __init__(self, site, detail=None):
        self.site = site
        super().__init__(f"chaos: injected fault at failpoint {site!r}"
                         + (f" ({detail})" if detail else ""))


class _Arm:
    __slots__ = ("site", "action", "value", "hits", "count", "calls", "fired", "rng")

    def __init__(self, site, action, value, hits, count):
        self.site = site
        self.action = action
        self.value = value
        self.hits = max(1, int(hits))
        self.count = None if count is None else max(1, int(count))
        self.calls = 0
        self.fired = 0
        # the same arm replays the same damage: crc32 of the site, not
        # hash(), which PYTHONHASHSEED moves
        self.rng = random.Random(zlib.crc32(site.encode("utf-8")))


def arm(site, action, value=None, hits=1, count=None):
    """Arm one failpoint: fire ``action`` from the ``hits``-th call on
    (1-based), at most ``count`` times (None: every call from then on)."""
    global _any_armed
    if action not in ACTIONS:
        raise MXNetError(f"chaos: unknown action {action!r} for site {site!r}; "
                         f"expected one of {ACTIONS}")
    a = _Arm(str(site), action, value, hits, count)
    with _lock:
        SITES.setdefault(a.site, "")
        _arms[a.site] = a
        _any_armed = True
    return a


def arms():
    """``{site: {action, value, hits, count, fired}}`` of every armed site."""
    with _lock:
        return {s: {"action": a.action, "value": a.value, "hits": a.hits,
                    "count": a.count, "fired": a.fired}
                for s, a in _arms.items()}


def reset():
    """Disarm everything."""
    global _any_armed
    with _lock:
        _arms.clear()
        _any_armed = False


def failpoint(site):
    """The injection hook: a global check unless something is armed."""
    if _any_armed:
        _fire(site, None)


def failpoint_bytes(site, data):
    """The hook of a site that produces bytes: ``data`` itself unless a
    ``corrupt`` arm fires, which returns damaged bytes."""
    if not _any_armed:
        return data
    return _fire(site, data)


def _fire(site, data):
    global _any_armed
    with _lock:
        a = _arms.get(site)
        if a is None:
            return data
        a.calls += 1
        if a.calls < a.hits:
            return data
        a.fired += 1
        hit = a.calls
        if a.count is not None and a.fired >= a.count:
            del _arms[site]   # consumed
            _any_armed = bool(_arms)
    flight.record("chaos", "inject", severity="error", site=site, action=a.action, hit=hit)
    log.warning("chaos: firing %s at %s (hit %d)", a.action, site, hit)
    if a.action == "corrupt":
        if data is None:
            raise ChaosInjectedError(site, "corrupt action armed on a failpoint without bytes")
        return _corrupt(a, data)
    cls = getattr(builtins, str(a.value), None) if a.value else None
    if isinstance(cls, type) and issubclass(cls, BaseException):
        raise cls(f"chaos: injected {a.value} at failpoint {site!r}")
    if a.value:
        raise ChaosInjectedError(site, f"unknown error class {a.value!r}")
    raise ChaosInjectedError(site)


def _corrupt(a, data):
    data = bytes(data)
    if a.value == "truncate":
        return data[:len(data) // 2]
    if not data:
        return data
    out = bytearray(data)
    for _ in range(max(1, len(out) // 100)):
        out[a.rng.randrange(len(out))] ^= 0xFF
    return bytes(out)
