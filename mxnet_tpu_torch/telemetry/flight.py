"""The flight recorder's ring of decision events (counterpart of
``record`` in ``mxnet_tpu/telemetry/flight.py``).

``record`` appends one ``{seq, t, mono, thread, category, event, severity,
fields}`` entry to a bounded ring under one lock; ``events`` reads it.
``enable``/``disable`` arm and disarm the ring (armed by default);
disarmed, ``record`` is one module-global check; ``clear`` empties it.
``dump_dir`` and ``prune`` are the dump files' directory
(``MXNET_FLIGHT_DIR``, then ``MXNET_WATCHDOG_DIR``, then the working
directory) and their retention (``MXNET_WATCHDOG_KEEP``), which the
numerics observatory's forensic dumps use.  Not ported: the
``MXNET_FLIGHT`` switch, the ring size knob and dumping the ring itself to
disk on a crash or a signal (ROADMAP Queue A 11d).
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time

log = logging.getLogger("mxnet_tpu_torch.telemetry.flight")

SEVERITIES = ("info", "warn", "error")

_lock = threading.Lock()
_ring = collections.deque(maxlen=1024)
_seq = 0
_armed = True


def enable():
    global _armed
    _armed = True


def disable():
    global _armed
    _armed = False


def enabled():
    return _armed


def _native(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_native(x) for x in v]
    return str(v)


def record(category, event, severity="info", **fields):
    """Append one decision event to the ring (nothing while disarmed)."""
    if not _armed:
        return
    global _seq
    entry = {"t": time.time(), "mono": time.monotonic(),
             "thread": threading.current_thread().name,
             "category": str(category), "event": str(event),
             "severity": severity if severity in SEVERITIES else "info",
             "fields": {k: _native(v) for k, v in fields.items()}}
    with _lock:
        _seq += 1
        entry["seq"] = _seq
        _ring.append(entry)


def events():
    """The ring's contents, oldest first."""
    with _lock:
        return list(_ring)


def clear():
    global _seq
    with _lock:
        _ring.clear()
        _seq = 0


# -- dump files ---------------------------------------------------------------
def _keep():
    from .. import config as _config
    return int(_config.get("MXNET_WATCHDOG_KEEP"))


def dump_dir():
    from .. import config as _config
    return (_config.get("MXNET_FLIGHT_DIR")
            or _config.get("MXNET_WATCHDOG_DIR") or os.getcwd())


def prune(directory, prefix, keep=None):
    """Keep the newest ``keep`` (``MXNET_WATCHDOG_KEEP``) files named
    ``prefix*`` in ``directory`` and remove the rest; returns the removed
    paths.  Best-effort: retention never fails the dump."""
    keep = _keep() if keep is None else int(keep)
    if keep <= 0:
        return []
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith(prefix) and not n.endswith(".tmp")]
    except OSError:
        return []
    paths = []
    for n in names:
        p = os.path.join(directory, n)
        try:
            paths.append((os.path.getmtime(p), p))
        except OSError:
            continue
    paths.sort(reverse=True)
    removed = []
    for _mt, p in paths[keep:]:
        try:
            os.remove(p)
            removed.append(p)
        except OSError as e:
            log.debug("flight: retention could not remove %s: %s", p, e)
    return removed
