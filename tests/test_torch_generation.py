"""The generation path of the PyTorch port (``mxnet_tpu_torch.serving``):
the cases of ``tests/test_generation.py`` whose modules the port has.

The engine runs ``tiny_lm`` on the CPU here (``device="cpu"``), where the
prefill's attention takes the kernel's plain version and the decode step
runs eagerly.  The pins are the JAX package's:

* a session's tokens are equal bit for bit batched and unbatched, greedy and
  seeded, with at least two sessions sharing a decode step;
* after ``warm()`` traffic adds no decode build (on the card: no capture);
* slot-pool admission charges the ledger and releases on every exit path;
* the prefix cache hits page-aligned heads, changes nothing bit for bit, and
  a version flip invalidates its entries;
* per-session traces tile the session with named stages;
* a non-finite decode row fails that session typed, its siblings stream on;
* a loop crash fails the active sessions typed and retryable.

Not ported here (their modules wait for later work): the Prometheus
families, ``ModelServer.load_generator``, the executor cache's retire hook
and the chaos harness's replica-kill scenario.

This file imports nothing of the JAX package.  The tests marked ``cuda``
need the card and skip without one; on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_generation.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch.chaos as chaos
from mxnet_tpu_torch.base import MXNetError, NonFiniteError
from mxnet_tpu_torch.ops import attention
from mxnet_tpu_torch.serving import (CohortQueue, GenerationEngine, KVPoolExhaustedError,
                                     KVSlotPool, PrefixCache, ServingOverloadError,
                                     ServingWorkerError, tiny_lm)
from mxnet_tpu_torch.serving import generation as gen_mod
from mxnet_tpu_torch.serving.kv_cache import pages_for
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.telemetry import flight, numerics
from mxnet_tpu_torch.telemetry import trace as mxtrace
from mxnet_tpu_torch.telemetry.resources import LEDGER

VOCAB, DM, MAXLEN = 24, 8, 64


def _engine(name, seed=2, prefix=0, slots=4, jit=True, device="cpu", **kw):
    model = tiny_lm(vocab=VOCAB, d_model=DM, max_len=MAXLEN, seed=seed, jit=jit,
                    device=device, **{k: kw.pop(k) for k in ("eos_id", "per_token_cost_s")
                                      if k in kw})
    return GenerationEngine(model, name=name, slots=slots, page_tokens=8, kv_budget_mb=8,
                            prefix_cache_entries=prefix, max_len=MAXLEN, **kw)


def _prompts():
    return [np.arange(1, 1 + n, dtype=np.int32) % (VOCAB - 1) + 1 for n in (5, 9, 13, 3)]


def _run_unbatched(name, greedy, seed=2, device="cpu"):
    eng = _engine(name, seed=seed, device=device)
    eng.warm()
    try:
        return [eng.generate(p, max_new_tokens=8, greedy=greedy, seed=7 + i)
                for i, p in enumerate(_prompts())]
    finally:
        eng.close()


def _run_batched(name, greedy, seed=2, device="cpu"):
    eng = _engine(name, seed=seed, device=device)
    eng.warm()
    try:
        sessions = [eng.start_session(p, max_new_tokens=8, greedy=greedy, seed=7 + i)
                    for i, p in enumerate(_prompts())]
        return [s.result(timeout=60) for s in sessions], eng.stats()
    finally:
        eng.close()


# -- bitwise identity ---------------------------------------------------------
def test_batched_greedy_bitwise_identical_to_unbatched():
    want = _run_unbatched("tgen-u-g", greedy=True)
    got, stats = _run_batched("tgen-b-g", greedy=True)
    assert got == want
    # batched for real: sessions shared decode steps
    assert stats["max_active"] >= 2
    assert stats["decode_steps"] < 4 * 8


def test_batched_seeded_sampling_bitwise_identical_to_unbatched():
    """Seeded host sampling reads every bit of the logits, so this pins the
    row independence of the fixed-shape decode step, the dropped padding
    rows of the prefill included."""
    want = _run_unbatched("tgen-u-s", greedy=False)
    got, stats = _run_batched("tgen-b-s", greedy=False)
    assert got == want
    assert stats["max_active"] >= 2


# -- one decode program -------------------------------------------------------
def test_zero_decode_compiles_after_warm():
    eng = _engine("tgen-compiles")
    warmed = eng.warm()
    try:
        assert warmed == [8, 16, 32, 64]
        s0 = eng.stats()
        assert s0["decode_compiles"] == 1   # exactly the warm build
        sessions = [eng.start_session(p, max_new_tokens=8) for p in _prompts()]
        for s in sessions:
            s.result(timeout=60)
        s1 = eng.stats()
        assert s1["decode_compiles"] == s0["decode_compiles"]
        assert s1["prefill_compiles"] == s0["prefill_compiles"]
        assert s1["tokens_emitted"] == 4 * 8
    finally:
        eng.close()


def test_prefill_dispatches_run_the_attention_kernel_once_each(monkeypatch):
    """Every prefill dispatch, warm buckets and cohorts alike, calls the
    flash-attention wrapper once, causal, at (B, 1, bucket, d_model); the
    decode step calls it never."""
    calls = []
    real = gen_mod.flash_attention

    def spy(q, k, v, causal=False, sm_scale=None):
        calls.append((tuple(q.shape), causal, sm_scale))
        return real(q, k, v, causal=causal, sm_scale=sm_scale)

    monkeypatch.setattr(gen_mod, "flash_attention", spy)
    eng = _engine("tgen-kernel")
    try:
        eng.warm()
        for s in [eng.start_session(p, max_new_tokens=4) for p in _prompts()]:
            s.result(timeout=60)
        st = eng.stats()
    finally:
        eng.close()
    assert len(calls) == st["prefill_dispatches"] > 4
    assert {c[1] for c in calls} == {True}
    assert {c[2] for c in calls} == {float(1.0 / np.sqrt(DM))}
    assert {c[0][:2] for c in calls} == {(4, 1)}
    assert {c[0][2] for c in calls[:4]} == {8, 16, 32, 64}
    assert {c[0][3] for c in calls} == {DM}


def test_padding_rows_never_write_a_live_slot():
    """A cohort's padding rows (``slot_rows == slots``) are dropped: slots
    that take no part in a prefill keep their k/v."""
    eng = _engine("tgen-pad", slots=4)
    try:
        eng.warm()
        marker = {n: a.clone() for n, a in eng._arena.items()}
        for a in eng._arena.values():
            a[2:].fill_(7.0)
        eng.generate(np.array([1, 2, 3], np.int32), max_new_tokens=1)
        for n, a in eng._arena.items():
            assert torch.equal(a[2:], torch.full_like(a[2:], 7.0)), n
            assert not torch.equal(a[:2], marker[n][:2])   # the session's slot
    finally:
        eng.close()


# -- slot pool and ledger -----------------------------------------------------
def test_slot_pool_ledger_roundtrip_and_idempotent_release():
    pool = KVSlotPool("generation/tt-pool", slots=2, page_tokens=8, bytes_per_token=64,
                      budget_bytes=1 << 20)
    a = pool.acquire("s1", 16)
    assert a.pages == pages_for(16, 8) == 2
    assert LEDGER.snapshot()["owners"]["generation/tt-pool"]["kv_pages"] == a.nbytes
    b = pool.acquire("s2", 6)
    with pytest.raises(KVPoolExhaustedError):
        pool.acquire("s3", 6)
    pool.release(a)
    pool.release(a)   # idempotent: a double release never goes negative
    pool.release(b)
    st = pool.stats()
    assert st["slots_in_use"] == 0 and st["kv_bytes"] == 0
    assert st["acquires"] == 2 and st["releases"] == 2 and st["sheds"] == 1
    assert LEDGER.snapshot()["owners"]["generation/tt-pool"]["kv_pages"] == 0


def test_kv_budget_blow_sheds_typed():
    pool = KVSlotPool("generation/tt-budget", slots=8, page_tokens=8, bytes_per_token=64,
                      budget_bytes=2 * 8 * 64)
    pool.acquire("s1", 16)   # exactly the budget
    with pytest.raises(KVPoolExhaustedError) as e:
        pool.acquire("s2", 2)
    assert isinstance(e.value, ServingOverloadError)
    assert isinstance(e.value, MXNetError)


def test_engine_pool_full_sheds_typed_and_admission_validates():
    eng = _engine("tgen-full", slots=1, jit=False, per_token_cost_s=0.01)
    try:
        hog = eng.start_session(np.arange(1, 5, dtype=np.int32), max_new_tokens=16)
        with pytest.raises(ServingOverloadError):
            eng.start_session(np.array([1, 2], np.int32), max_new_tokens=4)
        with pytest.raises(MXNetError):
            eng.start_session(np.array([], np.int32))   # empty prompt
        with pytest.raises(MXNetError):
            eng.start_session(np.array([1], np.int32), max_new_tokens=MAXLEN + 1)
        with pytest.raises(MXNetError):
            eng.start_session(np.array([VOCAB], np.int32))   # token out of range
        assert len(hog.result(timeout=60)) == 16
    finally:
        eng.close()
    st = eng.stats()
    assert st["kv"]["slots_in_use"] == 0 and st["kv"]["kv_bytes"] == 0


def test_sessions_release_ledger_to_zero():
    eng = _engine("tgen-ledger")
    eng.warm()
    try:
        sessions = [eng.start_session(p, max_new_tokens=6) for p in _prompts()]
        for s in sessions:
            s.result(timeout=60)
    finally:
        eng.close()
    assert LEDGER.snapshot()["owners"][f"generation/{eng.name}"]["kv_pages"] == 0
    st = eng.stats()["kv"]
    assert st["acquires"] == 4 and st["releases"] == 4


# -- prefix cache -------------------------------------------------------------
def test_prefix_cache_page_alignment_hit_and_miss():
    cache = PrefixCache("generation/tt-px", capacity=4, page_tokens=8)
    prompt = np.arange(1, 20, dtype=np.int32)   # 19 tokens
    stored = cache.store("m", 1, prompt, {"k": np.ones((19, 4), np.float32)})
    assert stored == 16 == cache.store_length(19)   # page-aligned clip
    hit_len, got = cache.lookup("m", 1, prompt)
    assert hit_len == 16 and got["k"].shape[0] == 16
    # a hit never covers the whole prompt: the last token is recomputed so
    # that the session has its first logits
    short = np.arange(1, 9, dtype=np.int32)
    cache.store("m", 1, short, {"k": np.ones((8, 4), np.float32)})
    assert cache.lookup("m", 1, short)[0] == 0
    assert cache.lookup("m", 1, np.arange(50, 60, dtype=np.int32))[0] == 0
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] >= 1


def test_prefix_cache_version_flip_invalidates():
    cache = PrefixCache("generation/tt-flip", capacity=4, page_tokens=8)
    prompt = np.arange(1, 20, dtype=np.int32)
    for model, version in (("m", 1), ("m", 2), ("other", 1)):
        cache.store(model, version, prompt, {"k": np.ones((19, 4), np.float32)})
    cache.evict_stale_versions("m", keep_versions={2})
    assert cache.lookup("m", 1, prompt)[0] == 0       # v1 gone
    assert cache.lookup("m", 2, prompt)[0] == 16      # v2 kept
    assert cache.lookup("other", 1, prompt)[0] == 16  # another model kept
    assert LEDGER.snapshot()["owners"]["generation/tt-flip"]["prefix_cache"] > 0
    cache.clear()
    assert LEDGER.snapshot()["owners"]["generation/tt-flip"]["prefix_cache"] == 0


def test_prefix_hit_is_bitwise_invisible():
    shared = np.arange(1, 20, dtype=np.int32) % (VOCAB - 1) + 1
    p1 = np.concatenate([shared, np.array([3, 4], np.int32)])
    p2 = np.concatenate([shared, np.array([5, 6, 7], np.int32)])
    eng = _engine("tgen-px", seed=3, prefix=8)
    eng.warm()
    try:
        a1 = eng.generate(p1, max_new_tokens=6)
        a2 = eng.generate(p2, max_new_tokens=6)   # hits p1's head
        assert eng.stats()["prefix_cache"]["hits"] >= 1
    finally:
        eng.close()
    ref = _engine("tgen-px-ref", seed=3, prefix=0)
    ref.warm()
    try:
        assert a1 == ref.generate(p1, max_new_tokens=6)
        assert a2 == ref.generate(p2, max_new_tokens=6)
    finally:
        ref.close()


# -- cohort queue -------------------------------------------------------------
def test_cohort_queue_anchors_oldest_and_joins_same_signature():
    q = CohortQueue(lambda x: x[0], max_cohort=3)
    for item in [(8, "a"), (16, "b"), (8, "c"), (8, "d"), (8, "e")]:
        q.put(item)
    # the anchor (8, "a") joins the later 8s, skipping the 16, up to 3
    assert q.take(timeout=0.0) == [(8, "a"), (8, "c"), (8, "d")]
    assert q.take(timeout=0.0) == [(16, "b")]
    assert q.take(timeout=0.0) == [(8, "e")]
    assert q.take(timeout=0.0) == []
    q.put((4, "f"))
    assert q.drain() == [(4, "f")] and len(q) == 0


# -- observability ------------------------------------------------------------
def test_generation_trace_stages_tile_the_session():
    mxtrace.enable()
    mxtrace.reset_exemplars()
    eng = _engine("tgen-trace")
    eng.warm()
    try:
        eng.generate(np.arange(1, 8, dtype=np.int32), max_new_tokens=6)
        doc = mxtrace.exemplars()["generation"]["last"]
    finally:
        eng.close()
        mxtrace.disable()
        mxtrace.reset_exemplars()
    stages = {s["stage"] for s in doc["stages"]}
    assert {"admit", "prefill_wait", "prefill", "decode_wait", "decode_step", "sample",
            "deliver"} <= stages
    assert doc["coverage"] >= 0.8, doc


def test_shed_admission_finishes_trace_typed():
    """A shed inside ``start_session`` finishes the session's trace, typed,
    instead of leaving it open."""
    mxtrace.enable()
    mxtrace.reset_exemplars()
    eng = _engine("tgen-shed-trace", slots=1, jit=False, per_token_cost_s=0.01)
    try:
        hog = eng.start_session(np.arange(1, 5, dtype=np.int32), max_new_tokens=16)
        with pytest.raises(ServingOverloadError):
            eng.start_session(np.array([1, 2], np.int32), max_new_tokens=4)
        docs = mxtrace.exemplars().get("generation", {})
        finished = list(docs.get("head", []))
        if docs.get("last") is not None:
            finished.append(docs["last"])
        rejected = [d for d in finished if d["status"] == "rejected"]
        assert rejected, f"the shed admission left its trace open: {docs}"
        assert any(e["event"] == "rejected" for e in rejected[0]["events"])
        assert len(hog.result(timeout=60)) == 16
    finally:
        eng.close()
        mxtrace.disable()
        mxtrace.reset_exemplars()


def test_intertoken_reservoir_observed():
    eng = _engine("tgen-inter")
    eng.warm()
    try:
        eng.generate(np.arange(1, 6, dtype=np.int32), max_new_tokens=6)
        gaps = eng.metrics.drain_observations("intertoken_ms")
        assert len(gaps) >= 5
        assert all(g >= 0.0 for g in gaps)
        assert gen_mod.stats()["tgen-inter"]["tokens_emitted"] == 6
    finally:
        eng.close()


# -- output health ------------------------------------------------------------
@pytest.mark.parametrize("jit", [False, True])
def test_nonfinite_decode_row_fails_typed_siblings_stream_on(jit):
    base = tiny_lm(vocab=VOCAB, d_model=DM, max_len=MAXLEN, seed=4, jit=jit, device="cpu")
    trig = VOCAB - 1
    inner = base.decode_fn

    def decode_nan(params, arena, tokens, pos):
        logits, arena = inner(params, arena, tokens, pos)
        if jit:
            return logits.masked_fill((tokens == trig)[:, None], float("nan")), arena
        logits = np.array(logits)
        logits[np.asarray(tokens) == trig] = np.nan
        return logits, arena

    base.decode_fn = decode_nan
    eng = GenerationEngine(base, name=f"tgen-nan-{jit}", slots=4, page_tokens=8,
                           kv_budget_mb=8, prefix_cache_entries=0, max_len=MAXLEN)
    try:
        # the victim's first decode step feeds its last prompt token, trig
        victim = eng.start_session(np.array([1, 2, trig], np.int32), max_new_tokens=8)
        sibling = eng.start_session(np.array([1, 2, 3], np.int32), max_new_tokens=8)
        with pytest.raises(NonFiniteError):
            victim.result(timeout=60)
        assert len(sibling.result(timeout=60)) == 8
        assert eng.stats()["sessions_failed"] == 1
        assert numerics.serving_nonfinite()[eng.name] == 1
        fam = telemetry.REGISTRY.get("mxnet_numerics_serving_nonfinite_total")
        assert fam.value(labels={"batcher": eng.name}) == 1
    finally:
        eng.close()
    assert eng.stats()["kv"]["slots_in_use"] == 0   # the victim's slot is free


def test_serving_guard_screens_rows_and_switches_off(monkeypatch):
    rows = np.ones((4, 3), np.float32)
    rows[1, 2] = np.nan
    rows[3, 0] = np.inf
    assert numerics.guard_rows([rows, np.zeros(4, np.int32)], 4) == {1, 3}
    assert numerics.guard_rows([np.ones((4, 3), np.float32)], 4) == ()
    try:
        numerics.set_serving_guard(False)
        assert not numerics.serving_guard()
        assert numerics.guard_rows([rows], 4) == ()
    finally:
        numerics.set_serving_guard(True)
    # the JAX package's switch, MXNET_NUMERICS_SERVING, read by configure()
    monkeypatch.setenv("MXNET_NUMERICS_SERVING", "0")
    try:
        numerics.configure()
        assert not numerics.serving_guard()
        assert numerics.guard_rows([rows], 4) == ()
    finally:
        monkeypatch.delenv("MXNET_NUMERICS_SERVING")
        numerics.configure()
    assert numerics.serving_guard()
    fam = telemetry.REGISTRY.get("mxnet_numerics_serving_nonfinite_total")
    before = fam.value(labels={"batcher": "tgen-guard"})
    numerics.record_serving_nonfinite("tgen-guard", 2)
    assert fam.value(labels={"batcher": "tgen-guard"}) == before + 2
    assert numerics.serving_nonfinite()["tgen-guard"] == before + 2


# -- hot reload ---------------------------------------------------------------
def test_engine_hot_reload_zero_post_flip_decode_compiles():
    eng = _engine("tgen-flip", seed=2)
    eng.warm()
    try:
        v1_out = eng.generate(np.arange(1, 8, dtype=np.int32), max_new_tokens=4)
        v2 = eng.load(tiny_lm(vocab=VOCAB, d_model=DM, max_len=MAXLEN, seed=9, device="cpu"))
        compiles_at_flip = eng.stats()["decode_compiles"]
        assert compiles_at_flip == 2   # one build a version, both before the flip
        v2_out = eng.generate(np.arange(1, 8, dtype=np.int32), max_new_tokens=4)
        st = eng.stats()
        assert st["version"] == v2
        assert st["decode_compiles"] == compiles_at_flip   # warmed before the flip
        assert v2_out != v1_out   # the new weights serve
        # retirement keeps {prev, new}: one flip of headroom, nothing older
        assert v2 in st["versions_resident"] and len(st["versions_resident"]) <= 2
        v3 = eng.load(tiny_lm(vocab=VOCAB, d_model=DM, max_len=MAXLEN, seed=5, device="cpu"))
        assert eng.stats()["versions_resident"] == [v2, v3]
    finally:
        eng.close()


def test_hot_reload_while_sessions_stream():
    """``load`` during traffic: the warm runs between the loop's ticks, the
    sessions in flight finish, and nothing leaks."""
    eng = _engine("tgen-flip-live", slots=4)
    eng.warm()
    try:
        sessions = [eng.start_session(p, max_new_tokens=24) for p in _prompts()]
        eng.load(tiny_lm(vocab=VOCAB, d_model=DM, max_len=MAXLEN, seed=9, device="cpu"))
        assert all(len(s.result(timeout=60)) == 24 for s in sessions)
        assert eng.stats()["decode_compiles"] == 2
    finally:
        eng.close()
    assert eng.stats()["kv"]["kv_bytes"] == 0


# -- failure fan-out ----------------------------------------------------------
def test_loop_crash_fails_active_sessions_typed_retryable():
    chaos.reset()
    eng = _engine("tgen-crash", jit=False, per_token_cost_s=0.005, loop_restarts=0)
    try:
        chaos.arm("serving/generation/decode", "raise", hits=2, count=1)
        sess = eng.start_session(np.arange(1, 5, dtype=np.int32), max_new_tokens=16)
        with pytest.raises(ServingWorkerError) as e:
            sess.result(timeout=60)
        assert e.value.retryable
        with pytest.raises(MXNetError):
            eng.start_session(np.array([1], np.int32))   # failed fast
        crash = [e for e in flight.events() if e["event"] == "generation_loop_crash"
                 and e["fields"]["engine"] == eng.name]
        assert crash and crash[-1]["fields"]["error"] == "ChaosInjectedError"
    finally:
        chaos.reset()
        eng.close()
    assert eng.stats()["kv"]["slots_in_use"] == 0   # nothing leaked


def test_loop_restart_keeps_serving():
    """With restarts left, a crash fails the sessions in flight typed and the
    loop serves the next ones."""
    chaos.reset()
    eng = _engine("tgen-restart", jit=False, loop_restarts=1)
    try:
        chaos.arm("serving/generation/decode", "raise", hits=1, count=1)
        with pytest.raises(ServingWorkerError):
            eng.generate(np.arange(1, 5, dtype=np.int32), max_new_tokens=4)
        assert len(eng.generate(np.arange(1, 5, dtype=np.int32), max_new_tokens=4)) == 4
        assert not eng.stats()["failed"]
    finally:
        chaos.reset()
        eng.close()


def test_session_streams_and_cancels():
    """Iterating a session yields its tokens as they decode; a cancelled
    session fails typed at the next tick and frees its slot."""
    with _engine("tgen-stream", jit=False, per_token_cost_s=0.002) as eng:
        sess = eng.start_session(np.arange(1, 6, dtype=np.int32), max_new_tokens=6)
        assert list(sess) == sess.result(timeout=60)
        slow = eng.start_session(np.arange(1, 6, dtype=np.int32), max_new_tokens=40)
        next(iter(slow))   # it streams
        slow.cancel()
        with pytest.raises(MXNetError, match="shut down"):
            slow.result(timeout=60)
        assert len(slow.tokens) < 40
        assert eng.stats()["kv"]["slots_in_use"] == 0
    assert eng.stats()["closed"]


def test_closed_engine_rejects_typed():
    eng = _engine("tgen-closed")
    eng.close()
    assert not eng._decode_fns and not eng._prefill_fns   # dropped at close
    with pytest.raises(MXNetError, match="shut down"):
        eng.start_session(np.array([1], np.int32))
    with pytest.raises(MXNetError, match="shut down"):
        eng.warm()


# -- on the card --------------------------------------------------------------
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode step is captured on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_batched_bitwise_and_one_capture(gpu):
    """On the card: one capture at warm, none from traffic; batched equal to
    unbatched bit for bit, greedy and seeded."""
    for greedy in (True, False):
        want = _run_unbatched(f"tgen-cu-u-{greedy}", greedy, device=gpu)
        got, stats = _run_batched(f"tgen-cu-b-{greedy}", greedy, device=gpu)
        assert got == want
        assert stats["decode_compiles"] == 1 and stats["max_active"] >= 2


@pytest.mark.cuda
def test_card_replay_matches_eager_decode(gpu):
    """The replayed decode step against the eager one from the same arena,
    and the prefill's attention launches against the engine's dispatches."""
    eng = _engine("tgen-cu-replay", device=gpu)
    try:
        attention.flash_attention_fwd.launches = 0
        eng.warm()
        step = eng._decode_fns[eng.stats()["version"]]
        assert step.graph is not None
        tokens = np.arange(4, dtype=np.int32) + 3
        pos = np.array([0, 5, 9, 2], np.int32)
        arena = {n: a.clone() for n, a in eng._arena.items()}
        eager = step.eager(arena, torch.from_numpy(tokens.astype(np.int64)).to(gpu),
                           torch.from_numpy(pos.astype(np.int64)).to(gpu))
        replayed = eng._on_loop(lambda: step(tokens, pos).clone())
        torch.testing.assert_close(replayed, eager, rtol=0, atol=0)
        for n in arena:
            torch.testing.assert_close(eng._arena[n], arena[n], rtol=0, atol=0)
        assert attention.flash_attention_fwd.launches == eng.stats()["prefill_dispatches"]
    finally:
        eng.close()
    del step
    # close dropped the graph: a capture after it is not disturbed by the
    # engine's graph being destroyed in its middle
    graph, x = torch.cuda.CUDAGraph(), torch.zeros(4, device=gpu)
    with torch.cuda.graph(graph):
        y = x + 1
    graph.replay()
    assert torch.equal(y, torch.ones(4, device=gpu))
