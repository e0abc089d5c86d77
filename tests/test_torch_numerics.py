"""The numerics observatory of the port (``mxnet_tpu_torch/telemetry/numerics.py``
inside ``fused_step.py``), the cases of ``tests/test_numerics.py`` at its
sizes (a 20-32-10 MLP, batch 16, 256 rows, K = 8, two windows), and the
port held to the JAX package:

- armed against off in the port, bit for bit (weights and optimizer
  states, SGD, SGD with momentum and wd, Adam; the scanned window and the
  single fused step), with equal dispatch counts; a poison detected within
  one window (flight event, counters, a dump naming window 2 and step 9);
  ``skip`` against a manual skip bit for bit; ``halt`` typed, with the
  window trace's status ``nonfinite``; the ``MXNET_NUMERICS_GRAD_NORM_MAX``
  rule; a bad mode; the disarmed check under 1 us; a ``LossScaler`` fed
  from the window; ``Monitor`` opting out of the fused step;
- the same ``.params`` and numpy data through both packages' ``Module.fit``
  armed: ``history()`` at rtol 1e-4 (``grad_norm``, ``param_norm``,
  ``loss``) and 1e-3 (``update_ratio``), ``nonfinite`` exactly; the same
  verdicts and counters after the same poison; the same ``stat_groups``;
  the same ``mxnet_numerics_*`` families (names, types, label keys).

The MLP's first layer has biases of +-3, so no pre-activation comes near
the ReLU kink (ROADMAP parity rules; ``test_no_preactivation_near_a_kink``
holds it).  The JAX package's runs are made once for the file (the
``jax_runs`` fixture).  On the CPU the fused step runs its captured
function eagerly.
"""
import glob
import json
import os
import re
import time

import numpy as np
import pytest

import jax

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import chaos, profiler
from mxnet_tpu_torch.base import MXNetError, NonFiniteError
from mxnet_tpu_torch.telemetry import flight, numerics, trace

CPU = mx.cpu()
HIDDEN, FEATURES, CLASSES = 32, 20, 10
BATCH, ROWS, K = 16, 256, 8
STAT_RTOL = {"grad_norm": 1e-4, "param_norm": 1e-4, "loss": 1e-4, "update_ratio": 1e-3}
SGD = {"learning_rate": 0.05}
_ENV_KEYS = ("MXNET_FUSED_STEP", "MXNET_SCAN_STEPS", "MXNET_NUMERICS",
             "MXNET_NUMERICS_GRAD_NORM_MAX", "MXNET_NUMERICS_DUMP_DIR")


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    """This file's JAX programs compile in process, never through JAX's
    persistent cache (``test_torch_registry.py``'s fixture, for the same
    reason); the setting is restored afterwards."""
    from jax._src import compilation_cache
    saved = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", saved)
    compilation_cache.reset_cache()


def _restore_env(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(autouse=True)
def _numerics_env(tmp_path):
    saved = {k: os.environ.get(k) for k in _ENV_KEYS}
    os.environ["MXNET_NUMERICS_DUMP_DIR"] = str(tmp_path)
    chaos.reset()
    numerics._reset_for_tests()
    try:
        yield
    finally:
        chaos.reset()
        numerics._reset_for_tests()
        _restore_env(saved)
        numerics.configure()


def _mlp(pkg):
    d = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(d, num_hidden=HIDDEN, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.FullyConnected(h, num_hidden=CLASSES, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _init_params(seed=5):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(HIDDEN, FEATURES) * 0.1).astype(np.float32),
            "fc1_bias": np.where(np.arange(HIDDEN) % 2 == 0, 3.0, -3.0).astype(np.float32),
            "fc2_weight": (rng.randn(CLASSES, HIDDEN) * 0.1).astype(np.float32),
            "fc2_bias": np.zeros(CLASSES, np.float32)}


def _dataset(n=ROWS, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, FEATURES).astype(np.float32),
            rng.randint(0, CLASSES, n).astype(np.float32))


def _fit(pkg, num, mode, x, y, scan_steps=K, optimizer="sgd", opt_params=None, monitor=None):
    """One epoch of ``Module.fit`` under ``mode`` in ``pkg`` (the port or the
    JAX package, with its own numerics module ``num``); returns the module
    and its parameters as numpy."""
    os.environ["MXNET_FUSED_STEP"] = "1"
    os.environ["MXNET_SCAN_STEPS"] = str(scan_steps)
    os.environ["MXNET_NUMERICS"] = mode
    num.configure()
    pkg.random.seed(0)
    ctx = pkg.cpu()
    it = pkg.io.NDArrayIter(pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx),
                            batch_size=BATCH, label_name="softmax_label")
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    mod.fit(it, num_epoch=1, optimizer=optimizer,
            optimizer_params=dict(opt_params or SGD),
            arg_params={k: pkg.nd.array(v, ctx=ctx) for k, v in _init_params().items()},
            monitor=monitor)
    params, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in params.items()}


def _port_fit(mode, x, y, **kw):
    return _fit(mx, numerics, mode, x, y, **kw)


def _opt_state_leaves(mod):
    out = {}
    for i, s in mod._updater.states.items():
        s = s if isinstance(s, tuple) else (s,)
        out[i] = [a.asnumpy() for a in s if a is not None]
    return out


def _families(text):
    """``{family: (type, sorted label-key tuples)}`` of the
    ``mxnet_numerics_*`` families in a Prometheus text."""
    types, keys = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE mxnet_numerics_"):
            _, _, fam, kind = line.split(" ", 3)
            types[fam] = kind
        elif line.startswith("mxnet_numerics_"):
            name = re.split(r"[{ ]", line, maxsplit=1)[0]
            labels = tuple(sorted(re.findall(r'(\w+)="', line.split(" ")[0])))
            keys.setdefault(name, set()).add(labels)
    return {f: (t, sorted(keys.get(f, ()))) for f, t in types.items()}


def _traffic(pkg, num, chaos_mod, telemetry_mod, tmp):
    """The same armed runs in either package: a clean warn fit, a warn fit
    whose window 2 is poisoned, a skip fit whose window 1 is poisoned, and a
    warn fit that breaches ``MXNET_NUMERICS_GRAD_NORM_MAX``.  Returns each
    run's history, summary and dump, and the families."""
    x, y = _dataset()
    saved = {k: os.environ.get(k) for k in _ENV_KEYS}
    os.environ["MXNET_NUMERICS_DUMP_DIR"] = tmp
    out = {}
    try:
        for name, mode, hits in (("clean", "warn", None), ("warn_poison", "warn", 2),
                                 ("skip_poison", "skip", 1), ("breach", "warn", None)):
            num._reset_for_tests()
            chaos_mod.reset()
            if hits is not None:
                chaos_mod.arm("train/poison_grad", "raise", hits=hits, count=1)
            if name == "breach":
                os.environ["MXNET_NUMERICS_GRAD_NORM_MAX"] = "1e-6"
            _fit(pkg, num, mode, x, y)
            os.environ.pop("MXNET_NUMERICS_GRAD_NORM_MAX", None)
            chaos_mod.reset()
            dumps = sorted(glob.glob(os.path.join(tmp, "mxnet-numerics-*.json")),
                           key=os.path.getmtime)
            doc = json.load(open(dumps[-1])) if dumps else None
            for d in dumps:
                os.remove(d)
            out[name] = {"history": num.history(), "summary": num.summary(), "dump": doc}
        out["families"] = _families(telemetry_mod.prometheus_dump())
    finally:
        num._reset_for_tests()
        chaos_mod.reset()
        _restore_env(saved)
        num.configure()
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    import mxnet_tpu as jmx
    from mxnet_tpu import telemetry as jtelemetry
    from mxnet_tpu.chaos import failpoints as jchaos
    from mxnet_tpu.telemetry import numerics as jnumerics
    return _traffic(jmx, jnumerics, jchaos, jtelemetry, str(tmp_path_factory.mktemp("jax_dumps")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    from mxnet_tpu_torch import telemetry
    return _traffic(mx, numerics, chaos, telemetry, str(tmp_path_factory.mktemp("port_dumps")))


# -- the port against itself ---------------------------------------------------
@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}),
])
@pytest.mark.parametrize("scan_steps", [K, 1])
def test_armed_bitwise_parity(optimizer, opt_params, scan_steps):
    """``warn`` over a fit (K = 8 windows, or single fused steps): weights
    and optimizer states bit for bit those of ``off``, the dispatches
    equal, and the stats in the history."""
    x, y = _dataset()
    profiler.reset_dispatch_counts()
    m_off, p_off = _port_fit("off", x, y, scan_steps=scan_steps, optimizer=optimizer,
                             opt_params=opt_params)
    d_off = profiler.dispatch_counts()
    numerics._reset_for_tests()
    profiler.reset_dispatch_counts()
    m_on, p_on = _port_fit("warn", x, y, scan_steps=scan_steps, optimizer=optimizer,
                           opt_params=opt_params)
    assert profiler.dispatch_counts() == d_off
    for k in p_off:
        assert np.array_equal(p_off[k], p_on[k]), k
    s_on, s_off = _opt_state_leaves(m_on), _opt_state_leaves(m_off)
    for i in s_off:
        for a, b in zip(s_on[i], s_off[i]):
            assert np.array_equal(a, b), i
    s = numerics.summary()
    assert s["steps"] == ROWS // BATCH and s["nonfinite_windows"] == 0
    assert s["windows"] == ROWS // BATCH // scan_steps
    last = numerics.history()[-1]
    assert last["kind"] == ("scan_window" if scan_steps > 1 else "fused_step")
    assert np.isfinite(last["grad_norm"]) and last["grad_norm"] > 0
    assert np.isfinite(last["param_norm"]) and last["param_norm"] > 0
    assert last["update_ratio"] > 0 and last["nonfinite"] == 0


def test_armed_accumulated_window_matches_off(monkeypatch):
    """Windows of K = 4 steps over M = 2 micro-batches each: ``warn`` bit for
    bit ``off``, one row a step, the loss proxy the mean over the step's two
    micro-batches' outputs."""
    monkeypatch.setenv("MXNET_SCAN_ACCUM", "2")
    x, y = _dataset()
    _m, p_off = _port_fit("off", x, y, scan_steps=4)
    numerics._reset_for_tests()
    _m, p_on = _port_fit("warn", x, y, scan_steps=4)
    for k in p_off:
        assert np.array_equal(p_off[k], p_on[k]), k
    hist = numerics.history()
    assert len(hist) == ROWS // BATCH // 2 and hist[-1]["step"] == ROWS // BATCH // 2
    assert all(np.isfinite(e["grad_norm"]) and e["nonfinite"] == 0 for e in hist)
    np.testing.assert_allclose([e["loss"] for e in hist], 1.0 / CLASSES, rtol=1e-6)


def test_poison_detected_with_flight_and_dump(tmp_path):
    """A ``train/poison_grad`` arm on window 2 is detected within that
    window: the flight event, the counters, and a dump naming window 2,
    step 9, the scanned window and the poisoned buckets."""
    flight.enable()
    flight.clear()
    x, y = _dataset()
    chaos.arm("train/poison_grad", "raise", hits=2, count=1)
    _port_fit("warn", x, y)
    s = numerics.summary()
    assert s["nonfinite_windows"] == 1 and s["nonfinite_steps"] == K
    assert s["skipped_updates"] == 0
    evs = [e for e in flight.events()
           if e["category"] == "numerics" and e["event"] == "nonfinite_window"]
    assert evs and evs[0]["severity"] == "error"
    assert evs[0]["fields"]["kind"] == "scan_window" and evs[0]["fields"]["action"] == "warn"
    dumps = sorted(glob.glob(str(tmp_path / "mxnet-numerics-*.json")))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["verdict"] == "nonfinite" and doc["mode"] == "warn"
    assert doc["window"] == 2 and doc["kind"] == "scan_window" and doc["bad_step"] == 9
    assert doc["rng_key_path"]["seed"] == 0
    assert doc["window_stats"] and doc["history"]
    assert doc["nonfinite_by_bucket"], "no bucket named"
    fam = mx.telemetry.REGISTRY.get("mxnet_numerics_nonfinite_windows_total")
    assert fam.value() >= 1


def test_dumps_are_pruned_to_the_watchdog_keep(tmp_path, monkeypatch):
    """Two poisoned windows write two dumps; ``MXNET_WATCHDOG_KEEP=1``
    leaves the newest, as ``flight.prune`` keeps every dump kind."""
    monkeypatch.setenv("MXNET_WATCHDOG_KEEP", "1")
    x, y = _dataset()
    chaos.arm("train/poison_grad", "raise", hits=1, count=2)
    _port_fit("warn", x, y)
    assert numerics.summary()["nonfinite_windows"] == 2
    assert mx.telemetry.REGISTRY.get("mxnet_numerics_dumps_total").value() >= 2
    left = glob.glob(str(tmp_path / "mxnet-numerics-*.json"))
    assert [os.path.basename(p) for p in left] == [f"mxnet-numerics-{os.getpid()}-2.json"]


def test_skip_mode_matches_manual_skip_bitwise():
    """``skip`` drops window 1's poisoned updates on the device and goes on
    bit for bit as a run over window 2's batches alone (no random op in the
    net, so no key to skip)."""
    x, y = _dataset()
    chaos.arm("train/poison_grad", "raise", hits=1, count=1)
    m_a, p_a = _port_fit("skip", x, y)
    s = numerics.summary()
    assert s["nonfinite_windows"] == 1 and s["skipped_updates"] == K
    numerics._reset_for_tests()
    m_b, p_b = _port_fit("off", x[ROWS // 2:], y[ROWS // 2:])
    for k in p_a:
        assert np.array_equal(p_a[k], p_b[k]), k
    s_a, s_b = _opt_state_leaves(m_a), _opt_state_leaves(m_b)
    for i in s_b:
        for a, b in zip(s_a[i], s_b[i]):
            assert np.array_equal(a, b), i


@pytest.mark.parametrize("scan_steps", [K, 1])
def test_halt_mode_raises_typed_nonfinite_error(scan_steps):
    """``halt``: ``NonFiniteError`` with the poisoned step and the dump;
    the window's trace records ``nonfinite_halt`` and finishes
    ``nonfinite``, and nothing runs per batch in its place."""
    x, y = _dataset()
    chaos.arm("train/poison_grad", "raise", hits=1, count=1)
    trace.reset_exemplars()
    trace.enable()
    profiler.reset_dispatch_counts()
    try:
        with pytest.raises(NonFiniteError) as ei:
            _port_fit("halt", x, y, scan_steps=scan_steps)
    finally:
        trace.disable()
    assert ei.value.retryable is False and ei.value.step == 1
    assert ei.value.dump_path and os.path.exists(ei.value.dump_path)
    counts = profiler.dispatch_counts()
    if scan_steps > 1:
        assert counts.get("scan_window") == 1 and not counts.get("fused_step")
        last = trace.exemplars()["train"]["last"]
        assert last["status"] == "nonfinite"
        assert [e["event"] for e in last["events"]] == ["nonfinite_halt"]
    else:
        assert counts.get("fused_step") == 1
    assert counts.get("graph", 0) == 0


def test_a_fused_step_is_judged_at_update():
    """A single fused step's stats are judged by ``update()`` (the fit
    loop's boundary, after it staged the next batch), or by the next step
    when no ``update()`` came: ``halt`` raises there, the poisoned step's
    outputs and arrays in place."""
    x, y = _dataset(2 * BATCH)
    os.environ["MXNET_FUSED_STEP"] = "1"
    numerics.configure(mode="halt")
    mod = mx.mod.Module(_mlp(mx), context=CPU)
    mod.bind(data_shapes=[("data", (BATCH, FEATURES))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=CPU) for k, v in _init_params().items()})
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params=SGD)
    batches = [mx.io.DataBatch([mx.nd.array(x[i:i + BATCH], ctx=CPU)],
                               [mx.nd.array(y[i:i + BATCH], ctx=CPU)])
               for i in (0, BATCH)]
    mod.forward_backward(batches[0])
    assert numerics.summary()["steps"] == 0
    mod.update()
    assert numerics.summary()["steps"] == 1
    chaos.arm("train/poison_grad", "raise", hits=1, count=1)
    mod.forward_backward(batches[1])
    assert mod._fused_step_done and numerics.summary()["steps"] == 1
    with pytest.raises(NonFiniteError) as ei:
        mod.update()
    assert ei.value.step == 2
    assert not np.isfinite(mod.get_params()[0]["fc1_weight"].asnumpy()).all()
    numerics.configure(mode="warn")
    mod.forward_backward(batches[0])
    mod.forward_backward(batches[1])     # judges step 3 first; step 4 waits
    assert numerics.summary()["steps"] == 3


def test_grad_norm_max_rule_breach(monkeypatch):
    monkeypatch.setenv("MXNET_NUMERICS_GRAD_NORM_MAX", "1e-6")
    flight.enable()
    flight.clear()
    x, y = _dataset(128)
    _port_fit("warn", x, y)
    s = numerics.summary()
    assert s["rule_breach_windows"] == 1 and s["nonfinite_windows"] == 0
    assert [e for e in flight.events()
            if e["category"] == "numerics" and e["event"] == "grad_norm_breach"]
    fam = mx.telemetry.REGISTRY.get("mxnet_numerics_rule_breaches_total")
    assert fam.value(labels={"rule": "grad_norm_max"}) >= 1


def test_bad_mode_rejected(monkeypatch):
    monkeypatch.setenv("MXNET_NUMERICS", "loud")
    with pytest.raises(MXNetError, match="MXNET_NUMERICS"):
        numerics.configure()


def test_disabled_boundary_check_is_cheap():
    """Disarmed: ``armed()`` and ``observe_window``'s early-out, best of 3
    (bench.py's method), under 1 us."""
    assert not numerics.armed()
    n, best = 20000, float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            numerics.armed()
            numerics.observe_window(None, "t", 0, 0)
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"the disabled check costs {best * 1e9:.0f} ns"


def test_loss_scaler_fed_from_the_window():
    """An attached ``LossScaler`` takes the window's step flags: 8 poisoned
    steps halve it 8 times, the clean window leaves it."""
    scaler = mx.amp.LossScaler(init_scale=2. ** 10, scale_window=1000)
    numerics.attach_loss_scaler(scaler)
    try:
        x, y = _dataset()
        chaos.arm("train/poison_grad", "raise", hits=1, count=1)
        _port_fit("skip", x, y)
        assert scaler.loss_scale == 2. ** 10 / 2 ** 8
    finally:
        numerics.detach_loss_scaler(scaler)
    assert scaler.has_overflow([np.array([1.0, np.inf], np.float32)])
    assert not scaler.has_overflow([None, np.ones(3, np.float32)])


def test_monitor_opts_out_of_fusion_and_numerics_is_the_alternative():
    """A ``Monitor`` keeps the per-parameter loop (no fused step, no
    window); ``monitor.numerics_summary()`` gives ``Monitor.toc()``-shaped
    rows from an armed fused fit."""
    x, y = _dataset(64)
    mon = mx.monitor.Monitor(interval=1, pattern="softmax_output")
    profiler.reset_dispatch_counts()
    mod, _ = _port_fit("warn", x, y, monitor=mon)
    counts = profiler.dispatch_counts()
    assert not counts.get("fused_step") and not counts.get("scan_window")
    assert mod._fused is None and mod._scan is None
    assert numerics.history() == []
    mon.tic()
    mod.forward(mx.io.DataBatch([mx.nd.array(x[:BATCH], ctx=CPU)],
                                [mx.nd.array(y[:BATCH], ctx=CPU)]), is_train=False)
    rows = mon.toc()
    assert [r[1] for r in rows] == ["softmax_output"] and float(rows[0][2]) > 0
    numerics._reset_for_tests()
    _port_fit("warn", x, y)
    rows = mx.monitor.numerics_summary()
    assert len(rows) == 4 * (64 // BATCH)
    step, stat, val = rows[-1]
    assert isinstance(step, int) and isinstance(val, str)
    assert {r[1] for r in rows} == {"grad_norm", "param_norm", "update_ratio", "loss"}


def test_no_preactivation_near_a_kink():
    """The data under the initial weights keeps every first-layer
    pre-activation at least 1 from the ReLU kink, so the cross-package
    holds below do not hinge on rounding at 0."""
    x, _ = _dataset()
    p = _init_params()
    z = x @ p["fc1_weight"].T + p["fc1_bias"]
    assert np.abs(z).min() > 1.0


# -- the port against the JAX package -------------------------------------------
@pytest.mark.parametrize("run", ["clean", "warn_poison", "skip_poison", "breach"])
def test_history_matches_the_jax_package(jax_runs, port_runs, run):
    got, want = port_runs[run]["history"], jax_runs[run]["history"]
    assert len(got) == len(want) == ROWS // BATCH
    for g, w in zip(got, want):
        assert (g["step"], g["kind"], g["window"]) == (w["step"], w["kind"], w["window"])
        assert g["nonfinite"] == w["nonfinite"], g["step"]
        for stat, rtol in STAT_RTOL.items():
            np.testing.assert_allclose(g[stat], w[stat], rtol=rtol, atol=0, equal_nan=True,
                                       err_msg=f"{run} step {g['step']} {stat}")


@pytest.mark.parametrize("run", ["warn_poison", "skip_poison", "breach"])
def test_verdicts_and_dumps_match_the_jax_package(jax_runs, port_runs, run):
    got, want = port_runs[run], jax_runs[run]
    assert got["summary"]["mode"] == want["summary"]["mode"]
    for key in ("windows", "steps", "nonfinite_steps", "nonfinite_windows",
                "rule_breach_windows", "skipped_updates"):
        assert got["summary"][key] == want["summary"][key], key
    gd, wd = got["dump"], want["dump"]
    for key in ("verdict", "kind", "window", "first_step", "bad_step", "steps", "mode",
                "nonfinite_by_bucket"):
        assert gd[key] == wd[key], key
    assert len(gd["window_stats"]) == len(wd["window_stats"])


def test_clean_run_summary_matches_the_jax_package(jax_runs, port_runs):
    got, want = port_runs["clean"]["summary"], jax_runs["clean"]["summary"]
    assert {k: v for k, v in got.items() if not k.startswith("grad_norm")} == \
        {k: v for k, v in want.items() if not k.startswith("grad_norm")}
    for key in ("grad_norm_last", "grad_norm_max", "grad_norm_median"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)


def test_families_match_the_jax_package(jax_runs, port_runs):
    got, want = port_runs["families"], jax_runs["families"]
    assert len(got) >= 11
    assert {f: v for f, v in got.items() if f != "mxnet_numerics_serving_nonfinite_total"} == \
        {f: v for f, v in want.items() if f != "mxnet_numerics_serving_nonfinite_total"}


@pytest.mark.parametrize("shapes,dtypes,bucket_mb", [
    ([(1 << 18,), (1 << 18,), (8,)], ["float32"] * 3, 1.0),
    ([(8,), (8,), (8,)], ["float32", "float16", "float32"], 64),
    ([(32, 20), (32,), (10, 32), (10,)], ["float32"] * 4, 0.001),
    ([(64, 3, 7, 7), (64,), (64,), (256, 64, 1, 1), (256,)],
     ["float32", "float32", "bfloat16", "bfloat16", "float32"], 0.05),
])
def test_stat_groups_equal_the_jax_package(shapes, dtypes, bucket_mb):
    from mxnet_tpu.telemetry import numerics as jnumerics
    names = [f"p{i}" for i in range(len(shapes))]
    want = jnumerics.stat_groups(shapes, dtypes, names=names, bucket_mb=bucket_mb)
    assert numerics.stat_groups(shapes, dtypes, names=names, bucket_mb=bucket_mb) == want
    import torch
    tdtypes = [getattr(torch, d) for d in dtypes]
    assert numerics.stat_groups(shapes, tdtypes, names=names, bucket_mb=bucket_mb) == want
