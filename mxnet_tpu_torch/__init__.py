"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu, for NVIDIA Hopper.

It imports torch and numpy, never jax and nothing of ``mxnet_tpu``.  Entry
points run on ``cuda:0`` unless the caller passes ``device="cpu"`` (or
``ctx=mx.cpu()``).  ``nd`` is ``mx.nd`` (NDArray, every registered
operator as ``nd.<op>``, creation, ``.params`` save and load),
``autograd`` is ``mx.autograd`` (``record``, ``backward``, ...), ``rtc``
is ``mx.rtc`` (CUDA C compiled by NVRTC), ``amp`` is ``mx.amp`` (mixed
precision), ``random`` is ``mx.random`` (``seed``), ``gluon`` is gluon (blocks,
layers, losses, ``Trainer``, ``SymbolBlock``, ``gluon.data`` with its
``DataLoader``, and ``gluon.contrib.estimator``), with ``optimizer``, ``lr_scheduler``,
``metric``, ``initializer`` (``init``) and ``config``; ``sym`` is ``mx.sym``
(Symbol, every operator as ``sym.<op>``, control flow), with ``executor``,
``mod`` (``mx.mod.Module``, the fused train step of ``fused_step``),
``io`` (the data iterators), ``callback``, ``model`` and ``monitor``
(``mx.monitor.Monitor``, and ``numerics_summary``, its fused-step
alternative); ``recordio``
(RecordIO files), ``image`` (decoding, augmenters, ``ImageIter``) and
``io_pipeline`` (the sharded reader pool and the fit loop's window feed)
are the data plane, ``telemetry`` the metric registry, spans and the
fit loop's step lanes, ``profiler`` is ``mx.profiler`` (the chrome trace,
over torch.profiler for the device); ``serving`` is
``mx.serving`` (``ModelServer``, the batcher, the router, the executor
cache and the generation engine) and ``compile`` its bucket ladder.
``kv`` (``kvstore``) is ``mx.kv``, the key-value store that ``Trainer``
and ``Module`` synchronize through, with ``gradient_compression`` its
2-bit codec; ``parallel`` holds the mesh layer and the data-parallel
``TrainStep``.  ``checkpoint`` is the async, atomic checkpoint manager
(its directories are the JAX package's format).  ``mx.cpu(i)`` and
``mx.gpu(i)`` are ``Context``s.
"""
from . import (amp, attribute, autograd, callback, checkpoint, compile, config, executor,
               fused_step,
               gluon, gradient_compression, image, initializer, io, io_pipeline, kvstore,
               lr_scheduler, metric, model, module, monitor, name, ndarray, optimizer, parallel,
               profiler,
               random,
               recordio, rtc, serving, symbol, telemetry)
from . import initializer as init
from . import kvstore as kv
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, default_device, gpu, num_gpus
from .ndarray import NDArray, waitall

__version__ = "0.1.0"

__all__ = ["AttrScope", "Context", "MXNetError", "NDArray", "amp", "attribute", "autograd",
           "callback", "checkpoint", "compile", "config", "cpu", "current_context", "default_device",
           "executor", "fused_step", "gluon", "gpu", "gradient_compression", "image", "init",
           "initializer", "io", "io_pipeline", "kv", "kvstore", "lr_scheduler", "metric", "mod",
           "model", "module", "monitor", "name", "nd", "ndarray", "num_gpus", "optimizer", "parallel",
           "profiler", "random", "recordio", "rtc", "serving", "sym",
           "symbol", "telemetry", "waitall"]
