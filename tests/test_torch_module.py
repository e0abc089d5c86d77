"""``Module`` of the port against the JAX package's, and the port's fused
step against its own per-parameter loop.

A narrow ``bench.py`` ``_resnet50_symbol`` (one unit in each of two
stages, widths 16 and 32, 32x32 images, 10 classes) trains through
``Module.fit`` for two batches in both packages from the same weights:
after step 1 every parameter is held within ``STEP1_TOL`` of its update's
largest magnitude, every momentum and BatchNorm statistic within
``STEP1_TOL`` of its own (the two frameworks round convolutions and
batch statistics differently); step 2's update is held in the 2-norm at
``tests/test_torch_gluon_train.py``'s ``KINK_TOL``, since a second step from weights that part by
rounding can cross a ReLU kink.  On the CPU the fused step
(``MXNET_FUSED_STEP=1``) and a scanned window (``MXNET_SCAN_STEPS=2``)
run the same function eagerly, so the port holds them to its loop bit
for bit.  Also: the checkpoint round trip (the JAX package reads the
port's files), ``BucketingModule``, ``SequentialModule`` and
``PythonLossModule``, ``NDArrayIter`` against the JAX iterator, and the
departures that raise.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

from torch_symbol_resnet import resnet50_symbol

NARROW = {"units": (1, 1), "filters": (16, 32), "stem": 8, "pool_kernel": 4,
          "num_classes": 10}
BATCH, BATCHES = 4, 2
STEP1_TOL = 1e-4
KINK_TOL = 0.1
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    """This file's JAX programs compile in process, never through JAX's
    persistent cache (``test_torch_attention.py``'s fixture, for the same
    reason); the setting is restored afterwards."""
    from jax._src import compilation_cache
    saved = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", saved)
    compilation_cache.reset_cache()


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(BATCH * BATCHES, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, BATCH * BATCHES).astype(np.float32)
    sym = resnet50_symbol(tmx.sym, **NARROW)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH, 3, 32, 32))
    args = {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("var") else np.zeros(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return x, y, args, aux


def _fit(pkg, data, knobs, monkeypatch):
    """Two batches of Module.fit; the state after each step (numpy)."""
    x, y, args, aux = data
    for k, v in knobs.items():
        monkeypatch.setenv(k, str(v))
    sym = resnet50_symbol(pkg.sym, **NARROW)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    states = []

    def snapshot(_param):
        a, x_ = mod.get_params()
        moms = {f"mom:{mod._param_names[i]}": s.asnumpy()
                for i, s in mod._updater.states.items()}
        states.append({**{f"param:{k}": v.asnumpy() for k, v in a.items()},
                       **{f"aux:{k}": v.asnumpy() for k, v in x_.items()}, **moms})

    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD, kvstore=None,
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in args.items()},
            aux_params={k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in aux.items()},
            batch_end_callback=snapshot)
    return mod, states


@pytest.fixture(scope="module")
def runs():
    data = _data()
    mp = pytest.MonkeyPatch()
    try:
        out = {"jax": _fit(jmx, data, {"MXNET_FUSED_STEP": 0}, mp)[1]}
        for name, knobs in (("loop", {"MXNET_FUSED_STEP": 0, "MXNET_SCAN_STEPS": 1}),
                            ("fused", {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 1}),
                            ("scan", {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 2})):
            mod, states = _fit(tmx, data, knobs, mp)
            out[name] = states
            out[name + "_module"] = mod
    finally:
        mp.undo()
    return data, out


@pytest.mark.parametrize("path", ["loop", "fused"])
def test_step1_matches_jax_tensor_by_tensor(runs, path):
    (_x, _y, args, aux), out = runs
    got, want = out[path][0], out["jax"][0]
    assert sorted(got) == sorted(want)
    bad = []
    for k, w in want.items():
        if k.startswith("param:"):
            scale = np.abs(w - args[k[6:]]).max()
        else:
            scale = np.abs(w).max()
        if np.abs(got[k] - w).max() > STEP1_TOL * max(scale, 1e-30):
            bad.append((k, float(np.abs(got[k] - w).max() / scale)))
    assert not bad, bad


@pytest.mark.parametrize("path", ["loop", "fused"])
def test_step2_update_matches_jax_in_the_2norm(runs, path):
    _data_, out = runs
    got, want = out[path], out["jax"]
    keys = [k for k in want[1] if k.startswith("param:")]
    up_got = np.concatenate([(got[1][k] - got[0][k]).ravel() for k in keys])
    up_want = np.concatenate([(want[1][k] - want[0][k]).ravel() for k in keys])
    assert np.linalg.norm(up_got - up_want) <= KINK_TOL * np.linalg.norm(up_want)


@pytest.mark.parametrize("path", ["fused", "scan"])
def test_fused_and_scan_equal_the_loop_bit_for_bit(runs, path):
    _data_, out = runs
    last = out[path][-1]
    for k, v in out["loop"][-1].items():
        assert np.array_equal(last[k], v), k
    mod = out[path + "_module"]
    if path == "fused":
        assert mod._fused.steps == BATCHES and mod._scan is None
    else:
        assert mod._scan.windows == 1 and mod._scan.steps == BATCHES
    assert out["loop_module"]._fused is None


def test_checkpoint_round_trip(runs, tmp_path):
    _data_, out = runs
    mod = out["loop_module"]
    prefix = str(tmp_path / "net")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    arg, aux = mod.get_params()
    back = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True, context=tmx.cpu())
    back.bind(data_shapes=mod.data_shapes, label_shapes=mod.label_shapes)
    back.init_params()
    back.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params=SGD)
    arg2, aux2 = back.get_params()
    for k in arg:
        assert np.array_equal(arg2[k].asnumpy(), arg[k].asnumpy()), k
    for k in aux:
        assert np.array_equal(aux2[k].asnumpy(), aux[k].asnumpy()), k
    for i, s in mod._updater.states.items():
        assert np.array_equal(back._updater.states[i].asnumpy(), s.asnumpy())
    jsym, jarg, jaux = jmx.model.load_checkpoint(prefix, 1)
    assert sorted(jarg) == sorted(arg) and sorted(jaux) == sorted(aux)
    assert np.array_equal(jarg["fc1_weight"].asnumpy(), arg["fc1_weight"].asnumpy())
    assert jsym.tojson() == mod.symbol.tojson()


def test_predict_pads_a_partial_batch(runs):
    (x, y, _a, _x), out = runs
    mod = out["loop_module"]
    it = tmx.io.NDArrayIter(x[:6], None, batch_size=BATCH, last_batch_handle="pad")
    got = mod.predict(it).asnumpy()
    assert got.shape == (6, 10)
    full = mod.predict(tmx.io.NDArrayIter(x[:BATCH], None, batch_size=BATCH)).asnumpy()
    assert np.array_equal(got[:BATCH], full)
    # the 2-row tail ran padded in the bound executor, not a rebound one
    tail = mod.predict(tmx.io.NDArrayIter(x[BATCH:6], None, batch_size=2)).asnumpy()
    assert tail.shape == (2, 10) and mod._exec.arg_dict["data"].shape[0] == BATCH
    np.testing.assert_allclose(got[BATCH:], tail, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle):
    rng = np.random.RandomState(1)
    x = rng.randn(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    batches = {}
    for pkg in (jmx, tmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
        epochs = []
        for _ in range(2):
            epochs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it])
            it.reset()
        batches[pkg.__name__] = (epochs, [(d.name, d.shape) for d in it.provide_data])
    (je, jd), (te, td) = batches["mxnet_tpu"], batches["mxnet_tpu_torch"]
    assert td == jd
    assert [[(d.shape, p) for d, _l, p in e] for e in te] == \
        [[(d.shape, p) for d, _l, p in e] for e in je]
    for ej, et in zip(je, te):
        for (dj, lj, _p), (dt, lt, _q) in zip(ej, et):
            assert np.array_equal(dt, dj) and np.array_equal(lt, lj)
    assert te[0][0][0].dtype == np.float32


def test_bucketing_module_shares_parameters():
    def sym_gen(key):
        data = tmx.sym.Variable("data")
        h = tmx.sym.FullyConnected(data, num_hidden=3, flatten=False, name="fc")
        h = tmx.sym.mean(h, axis=1)
        return tmx.sym.SoftmaxOutput(h, name="softmax"), ("data",), ("softmax_label",)

    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=5, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (2, 5, 4))], label_shapes=[("softmax_label", (2,))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(2)
    for key in (5, 3, 5):
        batch = tmx.io.DataBatch([tmx.nd.array(rng.randn(2, key, 4), ctx=tmx.cpu())],
                                 [tmx.nd.array(np.array([0, 2]), ctx=tmx.cpu())],
                                 bucket_key=key,
                                 provide_data=[("data", (2, key, 4))],
                                 provide_label=[("softmax_label", (2,))])
        before = mod.get_params()[0]["fc_weight"].asnumpy()
        mod.forward_backward(batch)
        mod.update()
        assert mod.get_outputs()[0].shape == (2, 3)
        assert not np.array_equal(mod.get_params()[0]["fc_weight"].asnumpy(), before)
    assert sorted(mod._buckets) == [3, 5]


def test_sequential_module_with_python_loss():
    rng = np.random.RandomState(4)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    feat = tmx.mod.Module(tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                                                 name="fc"), label_names=None,
                          context=tmx.cpu())

    def grad(scores, labels):
        p = scores.asnumpy()
        p = np.exp(p - p.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1
        return p / len(p)

    loss = tmx.mod.PythonLossModule(grad_func=grad)
    seq = tmx.mod.SequentialModule().add(feat).add(loss, take_labels=True)
    it = tmx.io.NDArrayIter(x, y, batch_size=4)
    w0 = None
    seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    seq.init_params(tmx.init.Xavier())
    seq.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    w0 = feat.get_params()[0]["fc_weight"].asnumpy()
    for batch in it:
        seq.forward(batch, is_train=True)
        seq.backward()
        seq.update()
    assert seq.get_outputs()[0].shape == (4, 3)
    assert not np.array_equal(feat.get_params()[0]["fc_weight"].asnumpy(), w0)


def test_feedforward_fits_and_predicts(tmp_path):
    rng = np.random.RandomState(5)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                                       num_hidden=3, name="fc"),
                                name="softmax")
    model = tmx.model.FeedForward(sym, ctx=tmx.cpu(), num_epoch=2, numpy_batch_size=4,
                                  initializer=tmx.init.Xavier(), learning_rate=0.1)
    model.fit(x, y)
    probs = model.predict(x)
    assert probs.shape == (8, 3) and np.allclose(probs.sum(1), 1, atol=1e-6)
    model.save(str(tmp_path / "ff"))
    back = tmx.model.FeedForward.load(str(tmp_path / "ff"), 2, ctx=tmx.cpu())
    assert np.array_equal(back.arg_params["fc_weight"].asnumpy(),
                          model.arg_params["fc_weight"].asnumpy())


def _small_module(**kw):
    sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                                       num_hidden=3, name="fc"),
                                name="softmax")
    mod = tmx.mod.Module(sym, context=tmx.cpu(), **kw)
    mod.bind(data_shapes=[("data", (2, 4))], label_shapes=[("softmax_label", (2,))])
    mod.init_params(tmx.init.Xavier())
    return mod


def _batch():
    return tmx.io.DataBatch([tmx.nd.array(np.ones((2, 4)), ctx=tmx.cpu())],
                            [tmx.nd.array(np.array([0, 1]), ctx=tmx.cpu())])


def test_dist_store_on_one_worker(monkeypatch):
    """``init_optimizer(kvstore='dist_sync')`` makes the store even on one
    device, with the optimizer in it, and a step through it equals the JAX
    Module's (whose dist store degrades the same way)."""
    monkeypatch.delenv("DMLC_NUM_WORKER", raising=False)
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    rng = np.random.RandomState(8)
    w = {"fc_weight": rng.randn(3, 4).astype(np.float32),
         "fc_bias": rng.randn(3).astype(np.float32)}
    x = rng.randn(2, 4).astype(np.float32)
    got = []
    for pkg in (tmx, jmx):
        sym = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                                           num_hidden=3, name="fc"),
                                    name="softmax")
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (2, 4))], label_shapes=[("softmax_label", (2,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in w.items()})
        mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        assert mod._kvstore.type == "dist_sync" and mod._update_on_kvstore
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                 [pkg.nd.array(np.array([0, 2]), ctx=pkg.cpu())])
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in w:
        np.testing.assert_allclose(got[0][k], got[1][k], rtol=1e-5, atol=1e-6)


def test_group2ctxs_places_the_groups():
    """``Module(group2ctxs=)`` in upstream's form (a group's list of
    contexts, one a device, of which the first is used with the first
    context): the ``ctx_group`` node runs on its group's context, and the
    Module trains as on one context."""
    data = tmx.sym.Variable("data")
    with tmx.AttrScope(ctx_group="dev1"):
        fc = tmx.sym.FullyConnected(data, num_hidden=3, name="fc")
    sym = tmx.sym.SoftmaxOutput(fc, name="softmax")
    mods = []
    for g2c in (None, {"dev1": [tmx.cpu(1)]}):
        mod = tmx.mod.Module(sym, context=[tmx.cpu(0), tmx.cpu(1)], group2ctxs=g2c)
        mod.bind(data_shapes=[("data", (2, 4))], label_shapes=[("softmax_label", (2,))])
        mod.init_params(tmx.init.Constant(0.1))
        mod.init_optimizer(kvstore=None, optimizer="sgd")
        mod.forward_backward(_batch())
        mod.update()
        mods.append(mod)
    grouped = mods[1]._exec
    node = next(n for n in grouped._symbol._topo() if n.name == "fc")
    assert grouped._grouped.node_context(node) == tmx.cpu(1)
    assert mods[0]._exec._grouped is None
    for k, v in mods[0].get_params()[0].items():
        np.testing.assert_array_equal(mods[1].get_params()[0][k].asnumpy(), v.asnumpy())


def test_departures_raise(tmp_path, monkeypatch):
    """The paths that raised until Queue A 11a and 11b: the checkpoint
    manager's, which now commit through it, ``StepTimeline``, which now logs
    the step lanes, and ``MXNET_NUMERICS=warn``, which now runs the fused
    step with the numerics observatory inside it (``summary()`` counts the
    step)."""
    mod = _small_module()
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path / "ck"), keep_last=0)
    try:
        mod.save_checkpoint(str(tmp_path / "m"), 1, manager=mgr).result(60)
        cb = tmx.callback.do_checkpoint(str(tmp_path / "m"), manager=mgr)
        assert cb.manager is mgr
        cb(1, mod.symbol, *mod.get_params())
        assert mgr.steps() == [1, 2]
        got = mgr.restore(1).arg_params
        for k, v in mod.get_params()[0].items():
            np.testing.assert_array_equal(got[k].asnumpy(), v.asnumpy())
    finally:
        mgr.close()
    timeline = tmx.callback.StepTimeline(frequent=1)
    assert timeline.frequent == 1
    timeline(tmx.model.BatchEndParam(epoch=0, nbatch=1, eval_metric=None, locals=None))
    mod.init_optimizer(kvstore=None, optimizer="sgd")
    monkeypatch.setenv("MXNET_NUMERICS", "warn")
    numerics = tmx.telemetry.numerics
    numerics._reset_for_tests()
    try:
        numerics.configure()
        mod.forward_backward(_batch())
        assert mod._fused_step_done
        mod.update()        # the boundary: the step's stats are judged here
        assert numerics.summary()["steps"] == 1
        assert numerics.history()[-1]["kind"] == "fused_step"
    finally:
        numerics._reset_for_tests()
        monkeypatch.delenv("MXNET_NUMERICS")
        numerics.configure()


def test_a_failing_fused_step_raises_and_never_falls_back(monkeypatch):
    mod = _small_module()
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={"momentum": 0.9})

    def broken(*args, **kwargs):
        raise RuntimeError("fused update broke")

    monkeypatch.setattr(mod._optimizer, "fused_update", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="fused update broke"):
            mod.forward_backward(_batch())
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    mod.forward_backward(_batch())
    mod.update()
    assert not mod._fused_step_done


def test_fused_step_done_flag_and_copy_in(monkeypatch):
    mod = _small_module()
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={"momentum": 0.9})
    mod.forward_backward(_batch())
    assert mod._fused_step_done
    mod.update()
    assert not mod._fused_step_done
    states = mod.get_optimizer_states()
    mod.set_optimizer_states(states)
    mod.forward_backward(_batch())
    mod.update()
    assert mod._fused.steps == 2
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    mod.forward(_batch())
    assert not mod._fused_step_done
