#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of the repository, on a machine with one CUDA device and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each: ``device``; ``build`` (nvcc for sm_90a, one
process per ``mxnet_tpu_torch/csrc/*.cu``, all at once, and the count of
tensor-core instructions in each library's SASS); ``kernel_check`` (each
kernel against its plain PyTorch version, forward and backward, at the
tolerance of its library entry, at its path's shape and layout and a few
others; for softmax_ce every kernel of its source in both dtypes, each
launch held to the kernel its launcher should pick);
paths, each driven with every kernel's launch count set to 0 just before
and read just after:

- ``slice``: 5 train steps of full-width ResNet-50 v1, batch 32, 224x224,
  fp32 (kernel: softmax_ce);
- ``slice_bf16``: the same 5 steps in bf16 AMP, as ``bench.py`` runs its
  step by default: a forward hook on the stem and on one bottleneck reads
  bf16 out of each convolution and f32 out of each BatchNorm, tensor hooks
  read f32 gradients, and softmax_ce must launch once a step on f32 logits
  and run the f32 warp kernel (kernel: softmax_ce);
- ``graph_step``: the fp32 and the bf16 step captured as one CUDA graph
  each (``capture_train_step``), 2 replays held to 2 eager steps of a copy
  of the net from the same state under cuDNN's deterministic algorithms
  (losses, parameters, momenta, BatchNorm statistics); softmax_ce counts
  its launches at capture (3 warm-up steps and the capture), none at
  replays;
- ``slice_nd``: full-width ResNet-50 v1 written as an ``mx.nd`` program
  (``tests/torch_nd_resnet.py``: ``nd.Convolution``, ``nd.BatchNorm``, ...,
  under ``mx.autograd.record()``, ``loss.backward()``, then
  ``nd.sgd_mom_update(w, w.grad, mom, out=w)`` per weight), 2 steps in fp32
  and 2 in bf16 AMP, each held to ``build_train_step``'s eager step from
  the same weights and batch, bit for bit in both dtypes (the same kernels
  on the same inputs); softmax_ce once a step, through
  ``nd.softmax_cross_entropy`` (kernel: softmax_ce);
  ``slice_nd_default_algorithms`` runs the same comparison again under
  cuDNN's default algorithm choice, as readings only: two eager steps from
  one state against each other, and the program against the eager step;
  ``slice_nd_kernels``: ``nd.LayerNorm`` at (8192, 768) f32 and
  ``nd.contrib.flash_attention`` at (8, 12, 1024, 64) causal, f32 and bf16,
  under ``record()`` with ``backward()``, bit for bit with direct calls of
  the kernels' autograd Functions (kernels: layernorm, 1 launch, and
  attention, 2);
- ``slice_gluon``: full-width ResNet-50 v1 built by ``vision.resnet50_v1()``
  with deferred shapes, saved to a ``.params`` file, then 2 steps in fp32
  and 2 in bf16 AMP from that file through gluon's training surface
  (``autograd.record()``, ``SoftmaxCrossEntropyLoss``, ``backward``,
  ``Trainer('sgd')`` with a ``FactorScheduler``, ``metric.Accuracy``),
  each held to ``build_train_step``'s eager step from the same file under
  cuDNN's deterministic algorithms (fp32: after step 1 every tensor and
  every update within ``GLUON_F32_REL`` of its scale, the losses within
  ``GLUON_F32_LOSS_REL``, step 2's update within ``GLUON_F32_STEP2_REL``
  in the 2-norm; bf16: every tensor bit for bit, the losses within
  ``GLUON_BF16_LOSS_REL``); the
  ``multi_sgd_mom_update`` calls a step must be ceil(193 / 4), and no kernel
  of the port launches (the loss is ``log_softmax`` + ``pick``);
  ``slice_gluon_kernels``: a gluon ``HybridSequential(Dense(3072),
  LayerNorm(), Dense(768))`` with deferred shapes at (8192, 768) f32, 2
  steps of ``Trainer('adam')`` under ``record()``: the LayerNorm layer's
  output bit-equal to ``fused_layer_norm`` on the same tensors (kernel:
  layernorm, 2 launches); and a channels-last ``Conv2D`` and ``MaxPool2D``
  at (32, 56, 56, 64) against their channels-first twins on permuted
  tensors, forward and backward, within ``GLUON_NHWC_TOL``;
- ``slice_hybridize``: ``slice_gluon``'s ResNet-50, file and steps with the
  net hybridized (each signature captured as CUDA graphs, forward and
  backward), held bit for bit to the same steps not hybridized in fp32
  and bf16 (losses, parameters, momenta, BatchNorm statistics), one
  capture a key;
- ``slice_module``: ``bench.py``'s ``_resnet50_symbol(1000)`` at full width
  (``tests/torch_symbol_resnet.py``), batch 32, fp32, through
  ``Module.fit`` over 4 batches from one saved Xavier state: the fused
  step (one CUDA graph a step), the per-parameter loop and two scanned
  windows of two, the fused and scanned runs bit-equal to the loop under
  cuDNN's deterministic algorithms;
  ``slice_module_kernels``: a narrow symbol (FullyConnected, LayerNorm,
  FullyConnected, ``MakeLoss(softmax_cross_entropy)``) through
  ``Module.fit``, loop and fused, 3 batches: layernorm and softmax_ce once
  a step in the loop, at the capture's warm-up and capture only in the
  fused run, the two bit-equal, the loss held to the plain versions; and a
  hybridized ``HybridSequential(Dense, LayerNorm, Dense)`` whose layernorm
  launches at its capture only, bit-equal to the Block not hybridized
  (kernels: layernorm and softmax_ce);
- ``slice_transformer``: one forward of the 12-layer pre-LN transformer
  stack at GPT-2 small's widths (embed 768, 12 heads, ffn 3072), batch 8 x
  1024 tokens, causal, fp32, under ``torch.no_grad()`` (kernels: layernorm,
  24 launches, and attention, 12);
- ``slice_mesh``: the mesh layer of ``mxnet_tpu_torch.parallel`` on a
  one-device mesh (dp = tp = sp = pp = ep = 1, no process group) at GPT-2
  small's block widths, batch 8 x 1024, causal, fp32: ``transformer_block_tp``
  (bit-equal to ``transformer_block_ref``), ``ring_self_attention``, the sp =
  8 ring's local steps in one process (``ring._fold`` over (8, 12, 128, 64)
  chunks: 8 diagonal and 28 full launches, 28 skipped; forward and the
  gradients of q, k and v against ``reference_attention``), ``gpipe_fn`` with
  4 microbatches, ``moe_ffn_ep`` (8 experts of the block's FFN, 4096 tokens)
  against ``moe_ffn``, and one ``pp_tp_train_step`` against its oracle; each
  sub-phase timed by CUDA events (kernels: attention, 49 launches, and
  layernorm, 24);
- ``rtc_full_width``: full-width ResNet-50 v1's 193 trainable tensors,
  synthetic gradients and momentum buffers held as ``mx.nd`` NDArrays
  without a copy (``nd.from_dlpack``); one SGD-with-momentum kernel in CUDA
  C, compiled by ``mx.rtc`` (NVRTC), launched once per tensor and held to
  ``sgd_mom_update``; MXNet's doc ``axpy`` over one buffer of 25 575 912
  floats; then ``save_parameters`` of the net and ``load_parameters`` into
  a net from another seed, bit-equal (kernel: rtc, 194 launches);
- ``slice_generation``: ``GenerationEngine`` serving ``tiny_lm`` at GPT-2's
  vocabulary and context (vocab 50 257, d_model 128, max_len 1024; 32
  slots, pages of 64 tokens, prefill cohorts of 4): ``warm()`` (8 prefill
  buckets and one decode capture), 64 sessions of 128 new tokens (48
  greedy, 16 sampled; half share a 256-token head), then 32 more with a hot
  reload after the 16th start.  Every prefill dispatch launches attention
  once (launches equal to the engine's dispatches), traffic captures
  nothing, the reload exactly once, the sessions started after it equal
  unbatched runs token for token, and every slot and page comes back
  (kernel: attention);
- ``slice_serving``: bench.py's ``measure_serving`` model, ``resnet18_v1()``
  at full width (224x224, 1000 classes, Xavier on seed 0), fp32, under
  cuDNN's deterministic algorithms, through ``ModelServer(max_batch_size=32,
  max_latency_ms=10, max_queue_depth=256)`` on the default context:
  ``load(block=net)`` traces the net into a Symbol, ``warm`` captures the
  bucket ladder (1, 2, ..., 32) as one CUDA graph a bucket, largest first,
  in one memory pool; each bucket's replay equals its executor's eager
  forward bit for bit; 64 single requests, batched by the server, equal
  ``net(x)`` alone within ``SERVE_TOL`` of the output's scale; the exported
  JSON loaded through ``prefix=`` equals ``block=`` bucket by bucket, bit for
  bit; a hot reload under traffic captures the new ladder before its flip
  and nothing after it; every batch after the captures is a replay
  (kernels: none of the port's, all counted at 0);
  ``slice_serving_kernels``: an exported ``HybridSequential(Dense(3072),
  LayerNorm(), Dense(10))`` served through ``prefix=`` equals its plain
  version at layernorm's tolerance, with layernorm launched at each
  bucket's warm-up run and capture and not at the replays; and
  ``ModelServer.load_generator`` of ``slice_generation``'s ``tiny_lm``, whose
  ``generate`` equals that engine alone token for token, one attention
  launch a prefill dispatch (kernels: layernorm and attention);
- ``slice_data``: bench.py's ``_resnet50_symbol(1000)`` at full width,
  batch 32, 224x224, fp32, under cuDNN's deterministic algorithms, trained
  by ``Module.fit`` with ``MXNET_SCAN_STEPS=2`` from 512 raw-pixel records
  written from seed 0 (deleted afterwards) through ``RecordFileSource`` ->
  ``DataPipeline(workers=2)`` -> ``WindowFeed``, 16 batches an epoch: the
  batches with 2 workers, and with one reader dying at ``io/reader/read``,
  bit-equal to ``workers=0``'s; ``RawRecordIter`` bit-equal to the source;
  the state after an epoch with the feed on, and with the failed reader,
  bit-equal to the feed off; the step's ms feed on and off,
  ``data_wait_pct``, the numpy reader's MB/s and the host ms to stage a
  window (kernels: none of the port's, all counted at 0);

- ``slice_gluon_data``: ``resnet50_v1()`` at full width (Xavier, seed 0),
  hybridized, bf16 AMP, ``Trainer('sgd')`` with lr 0.1, momentum 0.9 and wd
  1e-4, under cuDNN's deterministic algorithms, fed from 512 uint8 images
  (256, 256, 3) of seed 0 by ``gluon.data.DataLoader`` (batch 32, shuffled,
  ``pin_memory``, ``device_prefetch``): with CenterCrop(224), ToTensor and
  Normalize, an epoch's batches from 2 worker processes and from 2 worker
  threads bit-equal to ``num_workers=0``'s; 4 steps of ``Estimator.fit``
  fed by the 2-process loader bit-equal to a hand-written
  ``record``/``backward``/``step`` loop fed by the serial loader; the net
  exported and loaded back by ``SymbolBlock.imports(ctx=gpu(0))``, its fp32
  predict forward equal to the net's; each worker reports no ``jax``, no
  ``mxnet_tpu`` and no CUDA context; no child process, ``mx-*`` thread or
  ``/dev/shm`` entry left (kernels: none of the port's, all counted at 0);
- ``slice_spmd``: ``resnet50_v1()`` at full width (deferred shapes, Xavier
  on seed 0, batch 32, fp32, SGD with momentum) trained 3 steps by
  ``parallel.spmd.TrainStep`` on a one-rank mesh, every tensor after each
  step bit-equal to the gluon ``Trainer`` step from the same ``.params``
  file under cuDNN's deterministic algorithms (else slice_gluon's fp32
  bounds); ``slice_spmd_ranks``: the same net and batch on two processes
  started with ``spawn`` that share the card, ``dp=2`` x 16 rows over gloo
  (BatchNorm synced over ``dp``), 2 steps, each from the one-rank step's
  state before it and held to that step (``SPMD_RANKS_*``), the ranks
  bit-equal, nothing left behind;
  ``slice_kvstore``: the net's 193 trainable tensors through a
  ``'device'`` and an ``'ici'`` store, two gradient copies a key on
  ``gpu(0)`` pushed with SGD momentum in the store and pulled, bit-equal to
  ``multi_sgd_mom_update`` on the summed gradients; a 2-bit compressed
  ``'device'`` store over the whole gradient, its pulled sums and residuals
  bit-equal to the numpy codec on the host copies;
  ``Trainer(kvstore='device')`` over one context bit-equal to
  ``kvstore=None`` (kernels: none of the port's, all counted at 0);
- ``slice_dist``: the same net and batch trained by two ``dist_sync``
  workers, 16 rows each, sharing the card, with one parameter server, all
  started by ``mxnet_tpu_torch.launch`` on a free port (this script again,
  as ``--dist-worker``): ``Trainer(kvstore='dist_sync',
  update_on_kvstore=True)``, SGD with momentum on the server, 3 steps.
  Held bit for bit: (a) the two workers' pulled weights after every step;
  (b) the weights after step 1 against the port's CPU ``sgd_mom_update``
  on the sum of the two workers' step-1 gradients (each worker's in a
  ``.params`` file); (c) one 2-bit compressed round of those gradients
  (threshold 0.5, a store of its own), its server sums against the port's
  codec decoding both workers' payloads, every key (kernels: none of the
  port's, all counted at 0: gluon's loss bypasses softmax_ce);
  ``timing_dist``: the step's ms, each worker's split into forward and
  backward, push, the wait for the round and pull, the server's apply ms
  and the bytes on the wire a step with the rate they imply, taken in the
  workers' own processes;
- ``slice_group2ctx``: a two-group MLP (1024 -> 512, tanh, -> 10, batch
  64) bound with group ``dev1`` on ``cpu(0)`` and ``dev2`` on ``gpu(0)``,
  outputs and gradients against the same symbol on ``gpu(0)`` alone at the
  strict parity tolerance, each group's output on its device (kernels:
  none, all counted at 0);
- ``slice_checkpoint``: full-width ResNet-50 v1 under ``parallel.spmd.
  TrainStep`` on one rank (batch 32, 224x224, fp32, SGD with momentum), 4
  steps uninterrupted, then again with ``save_checkpoint`` through an async
  ``CheckpointManager`` after step 2 (the steps after it write the
  tensors in place at once), restored into a fresh ``TrainStep`` that runs
  steps 3-4; parameters, aux states and momenta bit for bit with the
  uninterrupted run.  The same for bench's ``_resnet50_symbol(1000)``
  through ``Module.fit`` with the fused step: 2 epochs of 2 batches
  uninterrupted, against 1 epoch with ``callback.module_checkpoint(manager=,
  save_optimizer_states=True)`` and a second epoch of the Module that
  ``restore_module`` gives, bit for bit; the checkpoints live in a
  temporary directory removed at the end (kernels: none, all counted at
  0, printed);
- ``slice_checkpoint_serving``: ``ModelServer`` in front of
  ``resnet18_v1()`` with ``repository.watch`` on a manager's directory:
  step 1 committed and served, step 2 with other weights committed and
  served within a few watch intervals, each bucket's replay of step 2 bit
  for bit with the eager forward of its executor and the answers equal to
  step 2's net alone within ``SERVE_TOL``; step 3 committed with
  ``checkpoint/writer/manifest`` armed ``corrupt``: quarantined, and step 2
  goes on serving (kernels: none, counted);
- ``slice_telemetry``: ``slice_module``'s run (full-width
  ``_resnet50_symbol(1000)``, batch 32, fp32, 4 batches from one saved
  state, cuDNN's deterministic algorithms) through ``Module.fit``, the loop
  and the fused step, each with ``telemetry.enable()`` and
  ``StepTimeline(frequent=2)`` and again with telemetry off: after the
  first step (the capture) the named lanes hold >= 90 % of the steps' wall,
  ``step_breakdown()``'s lanes plus ``other`` equal its wall, and every
  tensor equals the run with telemetry off bit for bit; prints each form's
  lanes in ms a step (kernels: none, counted);
- ``slice_numerics``: the numerics observatory (``MXNET_NUMERICS``) inside
  the fused step's and the scanned window's CUDA graphs, on ``slice_module``'s
  inputs (full-width ``_resnet50_symbol(1000)``, batch 32, fp32, 4 batches,
  deterministic cuDNN): ``warn`` fused and in windows of 2 bit for bit
  ``slice_module``'s ``off`` runs, with their captures, replays and
  dispatches, the stats finite and the first step's ``grad_norm`` within
  1e-5 of the 2-norm of the loop's gradients; ``skip`` with
  ``train/poison_grad`` on window 1 bit for bit an ``off`` run over batches
  3-4, 2 updates skipped; ``halt`` raising ``NonFiniteError`` at step 1
  with its dump written (a temporary directory, removed); then
  ``slice_module_kernels``' narrow symbol fused and armed: layernorm and
  softmax_ce launch at the capture only (4 each), and each step's loss stat
  is within 1e-6 of the mean of softmax_ce's loss (kernels: layernorm and
  softmax_ce);
- ``slice_profiler`` (run last, after every timing, since a profiler session
  slows the host): ``slice_module_kernels``' narrow symbol through the loop
  for 3 batches inside a span, ``mx.profiler`` running with ``profile_all``
  and ``profile_memory`` and ``MXNET_PROFILER_XPLANE_DIR`` a temporary
  directory (deleted): ``dump()`` holds the ops, the ``device_memory``
  counter lane and the span; ``dispatch_counts()`` one ``graph`` a forward
  and one a backward; the device trace counts ``ln_fwd_kernel`` and
  ``smce_kernel_*`` as often as their launch counters (3 each) and holds
  the span as a ``record_function`` range; prints the top device
  operations; then the same symbol through the fused step for 3 batches
  under the profiler: its dump holds ``train:fused_step_total`` at 3 and
  ``dispatch_counts()`` 3 ``fused_step`` (kernels: layernorm and
  softmax_ce);

``parity`` and ``parity_transformer`` (a narrow ResNet v1 train step, and a
2-layer stack's forward and gradients, on the card and on the CPU from the
same weights and inputs); ``parity_bf16`` (two steps of the narrow ResNet in
bf16 AMP on the card and on the CPU, held to ``BF16_PARITY_REL``);
``parity_generation`` (a narrow ``tiny_lm`` with the same weights on the
card and the CPU: prefill and decode logits and the arena at
``GEN_PARITY_TOL``, greedy tokens equal, and batched generations equal to
unbatched ones bit for bit on the card, greedy and seeded);
``multi_tensor_update`` (``multi_sgd_mom_update`` over ResNet-50's 193
trainable tensors against ``sgd_mom_update`` per tensor, both timed, with
the byte bound; ``multi_all_finite`` on clean and poisoned lists);
``parity_tf32_default`` (the same ResNet step
under torch's default flags, which run cuDNN's convolutions in TF32: the
relative error of the loss, the parameters, the momenta and the BatchNorm
statistics, held to ``TF32_PARITY_REL``); ``rtc`` (the cases of
``tests/test_rtc.py`` in CUDA C through ``mx.rtc``, a compile error and a
2048-thread launch that must raise, with NVRTC's seconds per source);
``timing``
(the ResNet-50 step in four configurations, fp32 and bf16, eager and
replayed from a CUDA graph: ms a step, img/s, the device's idle share of
the unprofiled step, and the profile's top kernels and device time by kind
of kernel; softmax_ce also at the LM-head shape, GPT-2's 50 257 words over
8 x 1024 tokens, and beside the device time of an empty kernel at its grid),
``timing_nd`` (the host microseconds of one ``invoke``, recording off and
on, beside ``torch.add``, and the ``mx.nd`` ResNet-50 step in fp32 and
bf16 by CUDA events beside ``build_train_step``'s eager step, with its
device idle share and its ``invoke`` calls a step),
``timing_hybridize`` (the hybridized gluon step in fp32 and bf16 beside
``timing_gluon``'s), ``timing_spmd`` (the one-rank ``TrainStep`` and the
gluon step of its loop by CUDA events beside ``build_train_step``, their
profiles and idle shares; the two-rank step's ms and collectives' share,
gloo on one card; the stores' push + pull ms), ``timing_module`` (the Module step fused, scanned
and looped, ms a step, launches a step and idle share, beside the
captured ``build_train_step``),
``timing_gluon`` (the gluon ResNet-50 step in fp32 and bf16 by CUDA
events beside the eager and ``mx.nd`` steps of the same process, its
device idle share, kernel launches and ``multi_sgd_mom_update`` calls a
step),
``timing_transformer`` (attention in f32 and bf16, and at the ring's
chunk, causal and full, beside SDPA), ``timing_serving`` (bench.py's
``measure_serving`` names: ``resnet18_serve_img_per_sec``, ``p50_ms``,
``p99_ms``, ``batch_occupancy``, ``offered``, ``completed``, ``shed``, over
a Poisson window of ``BENCH_SERVE_SECONDS`` at 1.2x the closed-loop probe,
taken before the first profiler session; the device's idle share over the
window from the replays at each bucket's replay time by CUDA events, and
from a shorter profiled window; the bucket-32 replay and its eager
executor forward by events, and the host's time in one batch),
``timing_telemetry`` (before the first profiler session: bench.py's
``measure_telemetry_overhead`` and ``measure_trace_overhead``, a disabled
span and a disabled trace stage plus a disarmed flight record, each under
1000 ns; ``slice_telemetry``'s fused step with the lanes on and off and its
loop with ``mx.profiler`` running and stopped, ms a step by CUDA events and
the host's clock, off-on-on-off),
``timing_numerics`` (before the first profiler session: bench.py's
``measure_numerics_overhead``, the disarmed check under 1000 ns, and the
16 x 256 MLP at batch 512 in windows of 8, armed against off, its
dispatches a step equal and the JAX package's 5 % budget printed beside
it; ResNet-50's fused step in off, warn and skip by CUDA events and the
host's clock with its step lanes, off-warn-skip-skip-warn-off, and the
bytes of each graph's private pool),
``timing_checkpoint`` (bench.py's ``measure_checkpoint``: on
``BENCH_CKPT_MB`` of host state and on the ResNet-50 ``TrainStep``'s
state taken from the card, the best of 3 of ``ckpt_save_blocking_ms``
(async), ``ckpt_save_sync_ms``, their ``blocking_fraction`` and
``ckpt_restore_s`` (checksums verified), the snapshot's device->host GB/s,
and the step's ms over 10 steps with an async save every 5 beside the same
loop without one),
``timing_data_pipeline`` (bench.py's ``measure_data_pipeline``: a
16-layer width-256 MLP, batch 512, K = 8, 16 steps an epoch, workers 0
against 2, the median of 3 epochs, taken before the first profiler
session: ``data_wait_pct``, ``serial_ratio``, the step's ms on both sides,
the same over epochs of 256 steps, and the launch calls and device
kernels a step from a profiled epoch of each side, which must be equal),
``timing_gluon_data`` (the random half of gluon's ImageNet recipe feeding
``slice_gluon_data``'s step, epoch 2 of 16 steps, before the first
profiler session: ms a step and ``data_wait_pct`` at 2 and 4 worker
processes, with the batches held on the card, and under
``Estimator.fit``; ``dataloader_img_per_sec``, ``tools/bench_pipeline.py``'s
DataLoader stage; the device's idle share over a profiled loader epoch),
``timing_generation``
(the decode step replayed from its graph and eager, a full prefill
dispatch, attention at the prefill's shape beside SDPA, and the device's
idle share over the slice's traffic from a profiled pass) and ``timing_rtc`` (CUDA
events, warm-up excluded, and the profiler's device time, for the library
calls too; the event times and host microseconds a call of the row kernels
and of ``mx.rtc`` are taken before the process's first profiler session;
``mx.rtc``'s pass is also captured once in a CUDA graph and replayed, each
replay from restored inputs and held to ``sgd_mom_update``).  Then one line
``{"kernels": [...]}``, the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.

TF32 is off for every phase but ``parity_tf32_default``, the timed ones
included: the fp32 numbers are strict fp32.  Any failure raises, so the script
exits non-zero and prints no last line; it does the same when CUDA is not
available.
"""
from __future__ import annotations

import copy
import gc
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH, IMAGE, STEPS = 32, 224, 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
NARROW = ([1, 1, 1, 1], [8, 32, 64, 128, 256], 10)
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5   # tests/test_torch_resnet.py
# GPT-2 small (Radford et al. 2019; the released gpt2 hparams): embed 768,
# 12 heads of 64, ffn 3072, 12 layers, context 1024; batch 8, causal
GPT2_SMALL = {"layers": 12, "embed": 768, "heads": 12, "ffn": 3072, "batch": 8,
              "seq": 1024}
GPT2_VOCAB = 50257   # the released gpt2 vocabulary: the LM head's softmax width
# the generation path: the JAX package's one generation model, tiny_lm (one
# layer, one head of d_model), at GPT-2's vocabulary and context; d_model 128
# is the widest head the attention kernel takes (ops/attention.py
# MAX_HEAD_DIM), so every prefill runs it
GEN = {"vocab": GPT2_VOCAB, "d_model": 128, "max_len": 1024, "seed": 0}
GEN_ENGINE = {"slots": 32, "page_tokens": 64, "kv_budget_mb": 64, "prefill_max_batch": 4,
              "prefix_cache_entries": 32}
GEN_BUCKETS = [8, 16, 32, 64, 128, 256, 512, 1024]
GEN_SESSIONS, GEN_RELOAD_SESSIONS, GEN_NEW_TOKENS, GEN_SHARED_HEAD = 64, 32, 128, 256
NARROW_GEN = {"vocab": 64, "d_model": 32, "max_len": 128}
# card against CPU: the attention kernel's f32 gate (kernels/library.py
# attention_tol), with an absolute floor at the logits' scale
GEN_PARITY_TOL = 2e-4
NARROW_TF = {"layers": 2, "embed": 64, "heads": 4, "ffn": 256, "batch": 2, "seq": 100}
# card (cuBLAS, no TF32) against CPU: the same f32 products summed in other
# orders through two layers; the absolute floor scales with the largest
# magnitude of each tensor, since gradients of out.sum() reach ~1e2
PARITY_TF_TOL = 1e-4
# slice_mesh: the mesh path on a one-device mesh at GPT-2 small's block
# widths.  The ring runs sp = 8 virtual ranks in one process over chunks of
# (8, 12, 128, 64); the MoE layer is 8 experts of GPT-2 small's FFN over the
# stack's 8 x 1024 tokens as 4096 of them, capacity factor 2.0.  Each result
# is held to its single-device version at the attention kernel's f32 gate
# (kernels/library.py attention_tol), with an absolute floor at each
# tensor's largest magnitude: both sides run the same f32 products, summed
# in other orders (microbatches, the ring's merges) and through 3xTF32
# attention.  The train step's parameter updates, far smaller than the
# parameters, are held to the same gate at each update's own scale
# (``_update_close``).  transformer_block_tp at tp = 1 runs
# transformer_block_ref's code op for op and is held bit for bit.
MESH = {"ring_sp": 8, "microbatches": 4, "moe_experts": 8, "moe_tokens": 4096,
        "moe_capacity_factor": 2.0, "lr": 0.05}
MESH_TOL = 2e-4
# rtc kernels against their plain versions: NVRTC contracts a * b + c into
# one FMA by default (--fmad=true), where the plain PyTorch version rounds
# the product first, so results differ in the last bit or two
RTC_RTOL, RTC_ATOL = 1e-6, 1e-7
# parity_tf32_default: torch's default flags run cuDNN's f32 convolutions in
# TF32, whose operands keep 10 explicit mantissa bits (unit roundoff 2**-11).
# A product of two rounded operands is off by at most 2 * 2**-11 of itself,
# and the f32 accumulation adds nothing at this scale.  The narrow net's
# longest chain runs 13 convolutions forward (the stem and 4 x 3 in the
# bottlenecks) and 13 backward (12 dgrad and 1 wgrad), so to first order, and
# without cancellation, each result is off by at most 26 * 2 * 2**-11 of its
# tensor's largest magnitude.  Set before any run on the card.
TF32_PARITY_REL = 26 * 2 * 2.0 ** -11
# ... except where the exact value is zero, so that the relative error has no
# scale: a convolution's bias directly ahead of a BatchNorm in train mode
# (BottleneckV1's first and last 1x1 convolutions) has an exact gradient of
# 0, since BatchNorm subtracts the batch mean, and after one step from a zero
# bias its parameter and momentum are rounding noise on both sides.  Those
# tensors are held to the strict phase's absolute tolerance, PARITY_ATOL.
ZERO_GRAD_TENSOR = re.compile(r"^(param|mom):.*_conv\d+_bias$")
# parity_bf16: the narrow step in bf16 AMP on the card against the CPU,
# two steps.  bf16 keeps 8 significant bits, so one rounding is off by at
# most 2**-8 of its value; the longest chain runs 14 bf16 products forward
# (the stem, 12 bottleneck convolutions, the dense layer) and 14 backward (13
# data gradients and the stem's weight gradient), each rounding its data
# operand and its output: 56 roundings, so to first order, and without
# cancellation, a result is off by at most 56 * 2**-8 of its scale.  The
# losses are held to it each, and the parameters, the BatchNorm statistics
# and the momenta each as a group in the 2-norm: BatchNorm's backward
# cancels terms of the size of its result, so one tensor can part by more
# (tests/test_torch_resnet.py, where the same bound holds the port to the
# JAX package).  Set before any run on the card.  The zero-gradient biases
# (ZERO_GRAD_TENSOR) have no scale of their own: each is also held, in
# absolute terms, to the bound times its group's largest magnitude.
BF16_PARITY_REL = 56 * 2.0 ** -8
BF16_STEPS = 2
# graph_step: replays against eager steps from the same state, under cuDNN's
# deterministic algorithms; f32 at the strict parity tolerance, bf16 at
# BF16_PARITY_REL (each group in the 2-norm), since max pooling's backward
# adds with atomics and one bf16 rounding that lands the other way grows
# through the next step as above.  Equal bit for bit is reported beside.
GRAPH_STEPS = 2
RESNET50_TRAINABLE = 25_575_912
SGD = {"lr": 0.01, "momentum": 0.9, "wd": 1e-4, "rescale_grad": 1.0}

# CUDA C compiled at run time by mx.rtc, as an MXNet user's would be.  The
# doc example of python/mxnet/rtc.py: no bounds check, so grid * block must
# be the size exactly.
AXPY_SRC = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
"""
AXPY_SIG = "const float *x, float *y, float alpha"
# MXNet's sgd_mom_update (mxnet_tpu/ops/_op_optimizer.py:45), grid-stride
SGD_MOM_SRC = r"""
extern "C" __global__ void sgd_mom(const float *grad, float *weight, float *mom,
                                   float lr, float momentum, float wd, float rescale,
                                   int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        float w = weight[i];
        float m = momentum * mom[i] - lr * (grad[i] * rescale + wd * w);
        mom[i] = m;
        weight[i] = w + m;
    }
}
"""
SGD_MOM_SIG = ("const float *grad, float *weight, float *mom, float lr, float momentum, "
               "float wd, float rescale, int n")
SGD_MOM_THREADS, SGD_MOM_MAX_BLOCKS = 256, 132 * 16
# the cases of tests/test_rtc.py in CUDA C
RTC_CASES_SRC = {
    "scale2": r"""
extern "C" __global__ void scale2(const float *x, float *a, float *b) {
    int i = threadIdx.x;
    a[i] = x[i] * 2.0f;
    b[i] = x[i] * 3.0f;
}
""",
    "rowscale": r"""
extern "C" __global__ void rowscale(const float *x, float *y, float alpha, int cols) {
    int row = blockIdx.x;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
        y[row * cols + c] = x[row * cols + c] * alpha;
}
""",
    "addi": r"""
extern "C" __global__ void addi(const int *x, int *y, int k) {
    int i = threadIdx.x;
    y[i] = x[i] + k;
}
""",
    "scale_t": r"""
template <typename T>
__global__ void scale_t(const T *x, T *y, T alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] * alpha;
}
""",
    "smem_reverse": r"""
extern "C" __global__ void smem_reverse(const float *x, float *y, int n) {
    extern __shared__ float buf[];
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
}
""",
    "scalars": r"""
extern "C" __global__ void scalars(float *out, unsigned short h, unsigned short b,
                                   double d, signed char i8, unsigned char u8) {
    out[0] = h; out[1] = b; out[2] = (float)d; out[3] = i8; out[4] = u8;
}
""",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel_name, iters=50):
    """Mean device time per call of fn() from one torch.profiler trace, read
    two ways: ``(total, own)``.  ``total`` sums the total device time of
    every event whose name holds ``kernel_name`` (the kernels' reading);
    ``own`` sums the self device time of CUDA events only, so each kernel
    counts once even under the empty filter a library call needs.  A trace
    that holds no such time at all is taken again, up to three traces; then
    each reading is None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel_name in e.key]
        total_us = sum(getattr(e, "device_time_total", 0.0) or 0.0 for e in events)
        own_us = sum(e.self_device_time_total for e in events
                     if e.device_type.name == "CUDA")
        if total_us > 0 or own_us > 0:
            break
    return tuple(us / 1e3 / iters if us > 0 else None for us in (total_us, own_us))


def kernel_device_ms(fn, kernel_name, iters=50):
    """``kernel_device_ms`` and ``kernel_self_device_ms`` of a kernel."""
    total, own = device_ms(fn, kernel_name, iters)
    return {"kernel_device_ms": total, "kernel_self_device_ms": own}


def library_device_ms(fn, iters=50):
    """Device time of every kernel that fn() launches, each counted once."""
    return device_ms(fn, "", iters)[1]


def tensor_core_instructions(build):
    """Per source, the HMMA and HGMMA instructions in ``cuobjdump -sass`` of
    its built library; None for every source where the toolkit has no
    cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    counts = {}
    for name in build.sources():
        if not os.access(tool, os.X_OK):
            counts[name] = None
            continue
        r = subprocess.run([tool, "-sass", str(build.library_path(name))],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0 and "does not contain device code" not in r.stdout + r.stderr:
            raise RuntimeError(f"cuobjdump -sass {name}: {r.stderr.strip()}")
        counts[name] = {op: len(re.findall(rf"\b{op}\b", r.stdout)) for op in ("HMMA", "HGMMA")}
    return counts


# kinds of kernel in a step's profile, by name, first match wins
KERNEL_KINDS = [
    ("softmax_ce", r"smce"), ("optimizer", r"foreach|multi_tensor"),
    ("layout", r"nchwToNhwc|nhwcToNchw"), ("batchnorm", r"\bbn_|batch_norm"),
    ("convolution", r"implicit_gemm|dgrad|wgrad|fprop|conv"), ("matmul", r"gemm"),
    ("pooling", r"pool"), ("cast_copy", r"copy"), ("reduction", r"reduce_kernel"),
    ("elementwise", r"elementwise"),
]


def kernel_kind(name):
    return next((kind for kind, pattern in KERNEL_KINDS if re.search(pattern, name)), "other")


def step_breakdown(fn, iters=3, top=12):
    """Device busy share of ``iters`` calls of fn() (summed kernel time over
    host wall time, one stream), the kernels that take the most time, and
    the device time and launches a call of each kind of kernel
    (``KERNEL_KINDS``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(t for _k, t, _c in kernels)
    kernels.sort(key=lambda k: -k[1])
    by_kind = {}
    for name, t, c in kernels:
        entry = by_kind.setdefault(kernel_kind(name), {"ms_per_step": 0.0, "calls_per_step": 0.0})
        entry["ms_per_step"] += t / 1e3 / iters
        entry["calls_per_step"] += c / iters
    return {"iters": iters, "wall_ms_per_step": wall_us / 1e3 / iters,
            "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]["ms_per_step"])),
            "device_busy_ms_per_step": busy_us / 1e3 / iters,
            "device_idle_share": 1.0 - busy_us / wall_us if busy_us else None,
            "top_kernels": [{"name": k[:80], "ms_per_step": t / 1e3 / iters,
                             "share_of_busy": t / busy_us, "calls_per_step": c / iters}
                            for k, t, c in kernels[:top]]}


def smce_inputs(n, d, dtype, seed, padding=True, offset=False):
    """Logits and int32 labels on the card.  ``offset``: the logits start one
    element past a 16-byte boundary (a contiguous view of a longer buffer),
    so no row-aligned 16-byte load applies."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if offset:
        x = (torch.randn(n * d + 1, generator=gen, device="cuda") * 3).to(dtype)[1:].view(n, d)
    else:
        x = (torch.randn(n, d, generator=gen, device="cuda") * 3).to(dtype)
    labels = torch.randint(0, d, (n,), generator=gen, device="cuda", dtype=torch.int32)
    if padding and n > 1:
        labels[0] = -1   # padding row
        labels[1] = d    # out of range
    return x, labels


# (n, d, dtype, logits one element off 16 bytes): every kernel of
# csrc/softmax_ce.cu in both dtypes (softmax_ce.VARIANTS), the path's shape
# first; the register/shared-memory boundary at d = 2048 / 2049; odd d, so
# rows start off 16 bytes and the staging takes a head and a tail; and rows
# past a block's shared memory (two_pass)
SMCE_CASES = [
    (32, 1000, torch.float32, False), (13, 7, torch.float32, False),
    (9, 200, torch.float32, False), (6, 301, torch.float32, False),
    (6, 512, torch.float32, False), (5, 1001, torch.float32, False),
    (32, 1000, torch.float32, True), (3, 1999, torch.float32, False),
    (7, 2048, torch.float32, False), (7, 2049, torch.float32, False),
    (256, 32000, torch.float32, False), (64, 50257, torch.float32, False),
    (16, 4096, torch.float32, True), (4, 65537, torch.float32, False),
    (13, 7, torch.bfloat16, False), (9, 256, torch.bfloat16, False),
    (6, 301, torch.bfloat16, False), (6, 512, torch.bfloat16, False),
    (5, 1001, torch.bfloat16, False), (32, 1000, torch.bfloat16, False),
    (3, 1999, torch.bfloat16, False), (7, 2048, torch.bfloat16, False),
    (256, 32000, torch.bfloat16, False), (64, 50257, torch.bfloat16, False),
    (16, 4096, torch.bfloat16, True), (2, 131073, torch.bfloat16, False),
]


def check_softmax_ce(entry, SoftmaxCE, plain_softmax_ce, smce):
    """Kernel vs plain, forward (loss, probs) and backward, for every case of
    ``SMCE_CASES``; each launch must run the kernel ``smce.expected_variant``
    names, and every kernel of the source must run.  Returns the largest
    absolute error at the main path's shape (32, 1000) f32."""
    main_err = None
    ran = set()
    for i, (n, d, dtype, offset) in enumerate(SMCE_CASES):
        rtol, atol = entry.tolerance(dtype)
        x, labels = smce_inputs(n, d, dtype, seed=100 + i, offset=offset)
        before = entry.launches
        loss_k, prob_k = entry.kernel(x, labels)
        torch.cuda.synchronize()
        if entry.launches != before + 1:
            raise RuntimeError("softmax_ce wrapper did not launch its kernel")
        variant = smce.last_variant()
        want = smce.expected_variant(d, dtype, x.data_ptr(), prob_k.data_ptr())
        if variant != want:
            raise RuntimeError(f"softmax_ce at {(n, d)} {dtype} ran {variant}, expected {want}")
        ran.add((str(dtype), variant))
        loss_p, prob_p = entry.plain(x, labels)
        torch.testing.assert_close(loss_k, loss_p, rtol=rtol, atol=atol)
        torch.testing.assert_close(prob_k.float(), prob_p.float(), rtol=rtol, atol=atol)
        ct = torch.rand(n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(i))
        xk = x.clone().requires_grad_(True)
        (SoftmaxCE.apply(xk, labels) * ct).sum().backward()
        xp = x.clone().requires_grad_(True)
        (plain_softmax_ce(xp, labels) * ct).sum().backward()
        torch.testing.assert_close(xk.grad.float(), xp.grad.float(), rtol=rtol, atol=atol)
        torch.cuda.synchronize()
        errs = {"loss": (loss_k - loss_p).abs().max().item(),
                "prob": (prob_k.float() - prob_p.float()).abs().max().item(),
                "grad": (xk.grad.float() - xp.grad.float()).abs().max().item()}
        if float(loss_k[0]) != 0.0 or float(loss_k[1]) != 0.0:
            raise RuntimeError("padding and out-of-range rows must have zero loss")
        emit("kernel_check", kernel=entry.name, shape=[n, d], dtype=str(dtype),
             logits_offset_bytes=x.data_ptr() % 16, variant=variant, rtol=rtol, atol=atol,
             max_abs_err=errs)
        if (n, d, dtype, offset) == (32, 1000, torch.float32, False):
            main_err = max(errs.values())
        del x, labels, loss_k, prob_k, loss_p, prob_p, xk, xp
    missing = {(str(t), v) for t in (torch.float32, torch.bfloat16)
               for v in smce.VARIANTS} - ran
    if missing:
        raise RuntimeError(f"softmax_ce kernels no case launched: {sorted(missing)}")
    return main_err


def resnet50(vision, Xavier, seed):
    """``resnet50_v1()`` with Xavier weights from a CPU generator seeded
    with ``seed``, its deferred shapes set by one forward of a 3-channel
    image (the draws are those of a net built with every shape)."""
    net = vision.resnet50_v1()
    net.initialize(Xavier(), ctx="cpu", generator=torch.Generator().manual_seed(seed))
    net.infer_shape(torch.zeros(1, 3, 32, 32))
    return net


def run_slice(build_train_step, library):
    step, params, _moms = build_train_step(batch=BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    losses = [float(step(x, y)) for _ in range(STEPS)]
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if launches["softmax_ce"] != STEPS:
        raise RuntimeError(f"softmax_ce launched {launches['softmax_ce']} times in "
                           f"{STEPS} steps")
    n_params = sum(w.numel() for w in params.values())
    emit("slice", model="resnet50_v1", batch=BATCH, image=IMAGE, dtype="float32",
         steps=STEPS, losses=losses, launches=launches, trainable_params=n_params,
         seconds=seconds)
    return step, x, y, launches


def _parity_results(build_train_step, vision, Xavier, dtype="float32", steps=1):
    """``steps`` narrow ResNet v1 train steps in ``dtype`` on the card and on
    the CPU from the same weights and batch: ``{device: {name: tensor}}`` of
    the losses, the parameters, the BatchNorm statistics and the momenta."""
    layers, channels, classes = NARROW
    net = vision.ResNetV1(vision.BottleneckV1, layers, channels, classes=classes)
    net.initialize(Xavier(), ctx="cpu", generator=torch.Generator().manual_seed(1))
    net.infer_shape(torch.zeros(1, 3, 64, 64))
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 3, 64, 64).astype(np.float32))
    y = torch.from_numpy(np.array([3, 0, 9, -1], np.int32))
    results = {}
    for device in ("cuda", "cpu"):
        local = copy.deepcopy(net)
        step, params, moms = build_train_step(batch=4, device=device, net=local, dtype=dtype)
        loss = torch.stack([step(x.to(device), y.to(device)) for _ in range(steps)])
        aux = {n: p._tensor() for n, p in local.collect_params().items() if p.is_aux}
        results[device] = {"loss": loss, **{f"param:{k}": v for k, v in params.items()},
                           **{f"aux:{k}": v for k, v in aux.items()},
                           **{f"mom:{k}": v for k, v in moms.items()}}
    return results


def run_parity(build_train_step, vision, Xavier):
    results = _parity_results(build_train_step, vision, Xavier)
    worst = 0.0
    for key, want in results["cpu"].items():
        got = results["cuda"][key].detach().cpu()
        torch.testing.assert_close(got, want.detach(), rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   msg=lambda m, key=key: f"{key}: {m}")
        worst = max(worst, (got - want.detach()).abs().max().item())
    emit("parity", net="ResNetV1(BottleneckV1, [1,1,1,1], [8,32,64,128,256], 10)",
         batch=4, image=64, tensors=len(results["cpu"]), rtol=PARITY_RTOL,
         atol=PARITY_ATOL, max_abs_err=worst, loss=float(results["cpu"]["loss"]))


def run_parity_tf32_default(build_train_step, vision, Xavier, defaults):
    """``run_parity``'s step under torch's default flags (``defaults``, read
    before the script set its own), where cuDNN runs the convolutions in
    TF32: each group's largest relative error, ``max |card - cpu|`` over
    ``max |cpu|`` of each tensor, held to ``TF32_PARITY_REL``.  The strict
    flags are restored for every later phase, whatever happens."""
    strict = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = defaults["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = defaults["matmul_allow_tf32"]
    try:
        results = _parity_results(build_train_step, vision, Xavier)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = strict
    rel = {"loss": 0.0, "param": 0.0, "mom": 0.0, "aux": 0.0}
    worst_tensor, zero_grad_abs = {}, {}
    for key, want in results["cpu"].items():
        got = results["cuda"][key].detach().cpu().float()
        want = want.detach().float()
        if ZERO_GRAD_TENSOR.match(key):
            zero_grad_abs[key] = (got - want).abs().max().item()
            continue
        scale = want.abs().max().item()
        err = (got - want).abs().max().item() / scale if scale > 0 else \
            (got - want).abs().max().item()
        group = "loss" if key == "loss" else key.split(":")[0]
        if err >= rel[group]:
            rel[group], worst_tensor[group] = err, key
    worst_zero = max(zero_grad_abs, key=zero_grad_abs.get, default=None)
    emit("parity_tf32_default", flags=defaults, tensors=len(results["cpu"]),
         max_rel_err=rel, worst_tensor=worst_tensor, tolerance=TF32_PARITY_REL,
         tolerance_from="26 TF32 products on the longest chain x 2 * 2**-11 each",
         zero_gradient_tensors=len(zero_grad_abs),
         zero_gradient_max_abs_err=zero_grad_abs.get(worst_zero, 0.0),
         zero_gradient_worst_tensor=worst_zero, zero_gradient_atol=PARITY_ATOL)
    failed = {g: e for g, e in rel.items() if not e <= TF32_PARITY_REL}
    if failed:
        raise RuntimeError(f"TF32 parity past {TF32_PARITY_REL}: {failed} ({worst_tensor})")
    if worst_zero is not None and not zero_grad_abs[worst_zero] <= PARITY_ATOL:
        raise RuntimeError(f"TF32 parity: {worst_zero} off zero by "
                           f"{zero_grad_abs[worst_zero]}, past {PARITY_ATOL}")
    return rel


def _group_rel_err(got, want):
    """The 2-norm of ``got - want`` over every tensor of a group over the
    2-norm of ``want`` (``{name: tensor}`` each)."""
    diff = sum(((got[k].double() - want[k].double()) ** 2).sum().item() for k in want)
    ref = sum((want[k].double() ** 2).sum().item() for k in want)
    return math.sqrt(diff / ref) if ref > 0 else math.sqrt(diff)


def _tensor_errs(got, want):
    """``{name: max |got - want| over its scale}`` of one group on the CPU:
    the tensor's largest magnitude, or its group's for a zero-gradient
    bias (ZERO_GRAD_TENSOR) or a tensor of zeros."""
    group_scale = max(t.abs().max().item() for t in want.values())
    errs = {}
    for k, t in want.items():
        scale = t.abs().max().item()
        if ZERO_GRAD_TENSOR.match(k) or scale == 0.0:
            scale = group_scale
        errs[k] = (got[k].double() - t.double()).abs().max().item() / scale
    return errs


def _groups(results):
    """``{group: {name: tensor on the CPU}}`` of ``_parity_results``' dict."""
    out = {}
    for key, t in results.items():
        group = "loss" if key == "loss" else key.split(":")[0]
        out.setdefault(group, {})[key] = t.detach().cpu()
    return out


def run_parity_bf16(build_train_step, vision, Xavier):
    """``run_parity``'s net, ``BF16_STEPS`` steps in bf16 AMP on the card and
    on the CPU: each loss, and the parameters, BatchNorm statistics and
    momenta as groups in the 2-norm, held to ``BF16_PARITY_REL``; every
    tensor f32 on both sides.  Each tensor's own largest relative error
    (max |err| / max |cpu|) is reported beside, and is not held."""
    results = _parity_results(build_train_step, vision, Xavier, dtype="bfloat16",
                              steps=BF16_STEPS)
    got, want = _groups(results["cuda"]), _groups(results["cpu"])
    wrong = [k for g in want for k in want[g]
             if want[g][k].dtype != torch.float32 or got[g][k].dtype != torch.float32]
    if wrong:
        raise RuntimeError(f"bf16 step: tensors not f32: {wrong[:5]}")
    losses = {"cuda": got["loss"]["loss"].tolist(), "cpu": want["loss"]["loss"].tolist()}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    group_rel = {g: _group_rel_err(got[g], want[g]) for g in ("param", "aux", "mom")}
    nonzero = {g: [k for k in want[g] if not ZERO_GRAD_TENSOR.match(k)] for g in ("param", "mom")}
    group_rel_nonzero = {g: _group_rel_err({k: got[g][k] for k in keys},
                                           {k: want[g][k] for k in keys})
                         for g, keys in nonzero.items()}
    # the zero-gradient biases have no scale of their own: each is held in
    # absolute terms to the bound times its group's largest magnitude
    zero_grad = {}
    for g in ("param", "mom"):
        scale = max(t.abs().max().item() for t in want[g].values())
        errs = {k: (got[g][k] - want[g][k]).abs().max().item()
                for k in want[g] if ZERO_GRAD_TENSOR.match(k)}
        worst = max(errs, key=errs.get)
        zero_grad[g] = {"tensors": len(errs), "worst_tensor": worst,
                        "max_abs_err": errs[worst], "bound": BF16_PARITY_REL * scale}
    tensor_rel = {}
    for g in ("param", "aux", "mom"):
        errs = {k: ((got[g][k] - want[g][k]).abs().max() / want[g][k].abs().max()).item()
                for k in want[g] if want[g][k].abs().max() > 0}
        worst = max(errs, key=errs.get)
        tensor_rel[g] = {"tensor": worst, "max_rel_err": errs[worst]}
    emit("parity_bf16", net="ResNetV1(BottleneckV1, [1,1,1,1], [8,32,64,128,256], 10)",
         batch=4, image=64, steps=BF16_STEPS, losses=losses, loss_rel_err=loss_rel,
         group_rel_err_2norm=group_rel,
         group_rel_err_2norm_without_zero_gradient_biases=group_rel_nonzero,
         zero_gradient_biases=zero_grad,
         worst_tensor_max_rel_err=tensor_rel,
         tolerance=BF16_PARITY_REL,
         tolerance_from="56 bf16 roundings on the longest chain x 2**-8 each")
    failed = {**{f"loss{i + 1}": e for i, e in enumerate(loss_rel) if not e <= BF16_PARITY_REL},
              **{g: e for g, e in group_rel.items() if not e <= BF16_PARITY_REL},
              **{f"zero_gradient_{g}": z for g, z in zero_grad.items()
                 if not z["max_abs_err"] <= z["bound"]}}
    if failed:
        raise RuntimeError(f"bf16 parity past {BF16_PARITY_REL}: {failed}")


def run_slice_bf16(build_train_step, vision, Xavier, library, smce):
    """Full-width ResNet-50 v1, batch 32, ``STEPS`` steps in bf16 AMP: a
    bottleneck's convolution gives bf16 and its BatchNorm f32, and so do the
    stem's; every parameter, gradient and momentum is f32; softmax_ce
    launches once a step, on f32 logits, and runs the f32 warp kernel."""
    net = resnet50(vision, Xavier, 0)
    step, params, moms = build_train_step(batch=BATCH, dtype="bfloat16", net=net)
    stem = list(net.features.children())
    body = list(list(stem[4].children())[0].body.children())
    seen = {}
    hooks = [m.register_forward_hook(
        lambda _m, _i, out, name=name: seen.setdefault(name, set()).add(str(out.dtype)))
        for name, m in (("stem_conv", stem[0]), ("stem_batchnorm", stem[1]),
                        ("block_conv", body[0]), ("block_batchnorm", body[1]),
                        ("dense", net.output))]
    grad_dtypes = set()
    hooks += [w.register_hook(lambda g: grad_dtypes.add(str(g.dtype))) for w in params.values()]
    launched_dtypes = []
    kernel_fn = smce._kernel_fn
    smce._kernel_fn = lambda dtype: (launched_dtypes.append(str(dtype)), kernel_fn(dtype))[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    torch.cuda.synchronize()
    try:
        library.reset_launches()
        t0 = time.perf_counter()
        losses = [float(step(x, y)) for _ in range(STEPS)]
        seconds = time.perf_counter() - t0
        launches = {name: k.launches for name, k in library.KERNELS.items()}
    finally:
        smce._kernel_fn = kernel_fn
        for h in hooks:
            h.remove()
    variant = smce.last_variant()
    # the step's logits and probabilities are fresh allocations, 16-byte aligned
    want_variant = smce.expected_variant(1000, torch.float32, 0, 0)
    want_dtypes = {"stem_conv": {"torch.bfloat16"}, "stem_batchnorm": {"torch.float32"},
                   "block_conv": {"torch.bfloat16"}, "block_batchnorm": {"torch.float32"},
                   "dense": {"torch.bfloat16"}}
    state_dtypes = {str(t.dtype) for t in list(params.values()) + list(moms.values())}
    emit("slice_bf16", model="resnet50_v1", batch=BATCH, image=IMAGE, dtype="bfloat16",
         steps=STEPS, losses=losses, launches=launches, seconds=seconds,
         output_dtypes={k: sorted(v) for k, v in seen.items()},
         parameter_and_momentum_dtypes=sorted(state_dtypes), gradient_dtypes=sorted(grad_dtypes),
         softmax_ce_logits_dtypes=sorted(set(launched_dtypes)), softmax_ce_variant=variant)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"bf16 step: non-finite loss {losses}")
    if seen != want_dtypes:
        raise RuntimeError(f"bf16 step: output dtypes {seen}, expected {want_dtypes}")
    if state_dtypes != {"torch.float32"} or grad_dtypes != {"torch.float32"}:
        raise RuntimeError(f"bf16 step: parameters and momenta {state_dtypes}, "
                           f"gradients {grad_dtypes}; all must be f32")
    if launches["softmax_ce"] != STEPS or launched_dtypes != ["torch.float32"] * STEPS:
        raise RuntimeError(f"bf16 step: softmax_ce launched {launches['softmax_ce']} times "
                           f"on {launched_dtypes} in {STEPS} steps")
    if variant != want_variant:
        raise RuntimeError(f"bf16 step: softmax_ce ran {variant}, expected {want_variant}")
    return step, x, y, launches


def run_graph_step(build_train_step, capture_train_step, capture_warmup, vision, Xavier,
                   library):
    """Full-width ResNet-50 v1, fp32 and bf16: ``GRAPH_STEPS`` replays of
    the captured step against as many eager steps of a copy of the net from
    the same state, under cuDNN's deterministic algorithms: the losses, and
    every parameter, momentum and BatchNorm statistic (``step.state``).
    softmax_ce's launches are counted over the capture (warm-up included)
    and over the replays, which add none: ``capture_warmup`` steps and the
    capture."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for dtype in ("float32", "bfloat16"):
            net = resnet50(vision, Xavier, 0)
            eager_net = copy.deepcopy(net)
            gen = torch.Generator(device="cuda").manual_seed(3)
            x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
            y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
            step, _, _ = build_train_step(batch=BATCH, dtype=dtype, net=net)
            eager, _, _ = build_train_step(batch=BATCH, dtype=dtype, net=eager_net)
            library.reset_launches()
            replay = capture_train_step(step, x, y)
            torch.cuda.synchronize()
            at_capture = library.get("softmax_ce").launches
            got = torch.stack([replay(x, y).clone() for _ in range(GRAPH_STEPS)])
            torch.cuda.synchronize()
            at_replays = library.get("softmax_ce").launches - at_capture
            want = torch.stack([eager(x, y) for _ in range(GRAPH_STEPS)])
            bitwise = torch.equal(got, want) and all(
                torch.equal(a, b) for a, b in zip(step.state, eager.state))
            state_got = {str(i): t for i, t in enumerate(step.state)}
            state_want = {str(i): t for i, t in enumerate(eager.state)}
            loss_rel = ((got - want).abs() / want.abs()).max().item()
            rel = _group_rel_err(state_got, state_want)
            max_abs = max((a - b).abs().max().item() for a, b in zip(step.state, eager.state))
            out[dtype] = {"losses_graph": got.tolist(), "losses_eager": want.tolist(),
                          "bitwise": bitwise, "loss_rel_err": loss_rel,
                          "state_rel_err_2norm": rel, "state_max_abs_err": max_abs,
                          "state_tensors": len(step.state),
                          "softmax_ce_launches_capture": at_capture,
                          "softmax_ce_launches_replays": at_replays}
            if at_capture != capture_warmup + 1 or at_replays != 0:
                raise RuntimeError(f"graph_step {dtype}: softmax_ce counted {at_capture} "
                                   f"at capture and {at_replays} at replays")
            if dtype == "float32":
                torch.testing.assert_close(got, want, rtol=PARITY_RTOL, atol=PARITY_ATOL)
                for a, b in zip(step.state, eager.state):
                    torch.testing.assert_close(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL)
            elif not (loss_rel <= BF16_PARITY_REL and rel <= BF16_PARITY_REL):
                raise RuntimeError(f"graph_step bf16: loss {loss_rel}, state {rel}, past "
                                   f"{BF16_PARITY_REL}")
            del net, eager_net, step, eager, replay
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit("graph_step", model="resnet50_v1", batch=BATCH, steps=GRAPH_STEPS,
         cudnn_deterministic=True, f32_rtol=PARITY_RTOL, f32_atol=PARITY_ATOL,
         bf16_tolerance=BF16_PARITY_REL, **out)
    return out


def _synthetic_grads(params, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(w.shape, generator=gen, device="cuda") * 0.01 for w in params]


def run_multi_tensor_update(build_train_step, sgd_mom_update, multi_sgd_mom_update,
                            multi_all_finite):
    """``multi_sgd_mom_update`` over full-width ResNet-50's trainable tensors,
    held to ``sgd_mom_update`` per tensor from the same inputs (at the rtc
    kernels' tolerance: the two run the same operations, but a compiler may
    contract a product and a sum into one FMA in either); both timed by
    CUDA events (each call from the state the last left), with the pass's
    byte bound.  ``multi_all_finite`` on the same list, clean and with one
    inf or nan."""
    _step, params, _moms = build_train_step(batch=BATCH)
    weights = [w.detach() for w in params.values()]
    grads = _synthetic_grads(weights, 21)
    moms = [g * 0.5 for g in _synthetic_grads(weights, 22)]
    multi_w, multi_m = [w.clone() for w in weights], [m.clone() for m in moms]
    loop_w, loop_m = [w.clone() for w in weights], [m.clone() for m in moms]
    attrs = {"wd": SGD["wd"], "momentum": SGD["momentum"], "rescale_grad": SGD["rescale_grad"]}

    def multi(ws=multi_w, ms=multi_m):
        multi_sgd_mom_update(ws, grads, ms, lrs=SGD["lr"], wds=attrs["wd"],
                             momentum=attrs["momentum"], rescale_grad=attrs["rescale_grad"])

    def loop(ws=loop_w, ms=loop_m):
        for w, g, m in zip(ws, grads, ms):
            sgd_mom_update(w, g, m, lr=SGD["lr"], **attrs)

    multi()
    loop()
    torch.cuda.synchronize()
    err = max(max(_max_err(a, b) for a, b in zip(multi_w, loop_w)),
              max(_max_err(a, b) for a, b in zip(multi_m, loop_m)))
    bitwise = all(torch.equal(a, b) for a, b in zip(multi_w + multi_m, loop_w + loop_m))
    n = sum(w.numel() for w in weights)
    nbytes = 5 * 4 * n   # read g, read and write w and m, f32
    finite = {"clean": float(multi_all_finite(*grads))}
    for bad in ("inf", "nan"):
        poisoned = list(grads)
        poisoned[7] = grads[7].clone()
        poisoned[7].view(-1)[3] = float(bad)
        finite[bad] = float(multi_all_finite(*poisoned))
    t = {"tensors": len(weights), "floats": n, "max_abs_err": err, "bitwise": bitwise,
         "ms": cuda_ms(multi, iters=20), "loop_ms": cuda_ms(loop, iters=20),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes,
         "multi_all_finite": finite}
    emit("multi_tensor_update", rtol=RTC_RTOL, atol=RTC_ATOL, **t)
    for a, b in zip(multi_w + multi_m, loop_w + loop_m):
        torch.testing.assert_close(a, b, rtol=RTC_RTOL, atol=RTC_ATOL)
    if finite != {"clean": 1.0, "inf": 0.0, "nan": 0.0}:
        raise RuntimeError(f"multi_all_finite: {finite}")
    return t


# -- the mx.nd path: the op registry, dispatch and autograd ----------------------
# slice_nd: full-width ResNet-50 v1 written as an mx.nd program
# (tests/torch_nd_resnet.py), two steps in fp32 (TF32 off) and two in bf16
# AMP, against build_train_step's eager step from the same net and batch.
# The two run the same kernels in the same order where the program's ops
# are ops/nn.py's; in bf16 the program adds only the casts invoke makes at
# dispatch (dot, softmax, broadcast_*: the residual add), which must change
# no bit.  So the loss, every parameter, momentum and BatchNorm statistic is
# held bit for bit in both dtypes, under cuDNN's deterministic algorithms,
# as graph_step's comparison runs: without them the two steps agreed to
# 7e-7 in the losses, and BatchNorm's backward, which cancels terms of the
# size of its result, grew the difference to 9.85 % of a momentum's scale
# after two steps (mom:stage4_conv1_weight, fp32, on an H100 80GB HBM3).
# Each group's worst tensor, its largest error over its largest magnitude,
# is emitted beside the verdict.
ND_STEPS = 2
# nd.LayerNorm and nd.contrib.flash_attention at the transformer path's
# shapes, under record() with backward(), against direct calls of the
# kernels' autograd Functions on the same inputs: bit for bit
ND_LN_SHAPE = (8192, 768)
ND_ATTN_SHAPE = (8, 12, 1024, 64)


def _nd_program():
    """``tests/torch_nd_resnet.py``, the mx.nd program (imports no JAX)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_nd_resnet
    return torch_nd_resnet


def _nd_results(P, M, loss, specs):
    out = {"loss": loss}
    for name, _shape, trainable in specs:
        out[f"{'param' if trainable else 'aux'}:{name}"] = P[name]._data.detach()
        if trainable:
            out[f"mom:{name}"] = M[name]._data
    return out


def _nd_compare(got, want):
    """Hold the mx.nd step's state (``got``) to the eager step's (``want``),
    both ``{"loss": tensor, "group:name": tensor}``, bit for bit; returns
    the readings and the tensors that differ.  A zero-gradient bias
    (ZERO_GRAD_TENSOR), which has no scale of its own, reads its error over
    its group's scale."""
    got, want = _groups(got), _groups(want)
    worst = {}
    for g in want:
        errs = _tensor_errs(got[g], want[g])
        k = max(errs, key=errs.get)
        worst[g] = {"tensor": k, "max_err_over_scale": errs[k]}
    failed = [k for g in want for k in want[g] if not torch.equal(got[g][k], want[g][k])]
    losses = {"nd": got["loss"]["loss"].tolist(), "eager": want["loss"]["loss"].tolist()}
    return {"losses": losses, "tolerance": "bit for bit", "bitwise": not failed,
            "worst_tensor": worst}, failed


def run_slice_nd(mx, library, vision, Xavier, build_train_step):
    """Full-width ResNet-50 v1, batch 32: ``ND_STEPS`` steps of the mx.nd
    program in fp32 and in bf16 AMP, each from the weights of the slice's
    net (Xavier, seed 0) and held to ``build_train_step``'s eager step from
    the same weights and batch, both under cuDNN's deterministic
    algorithms.  softmax_ce must launch exactly once a step (f32 logits in
    both dtypes), no other kernel.  Returns the program's steps (for
    ``timing_nd``, which runs them under torch's default cuDNN choice),
    the launches and the ``invoke`` calls a step."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps, launches, invokes, state = _slice_nd(mx, library, vision, Xavier,
                                                    build_train_step)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _nd_default_algorithms(mx, build_train_step, state)
    return steps, launches, invokes


def _eager_states(build_train_step, net, x, y, dtype, cut, steps=ND_STEPS):
    """``steps`` of ``build_train_step``'s eager step on ``net`` (moved to
    the card): after each step, ``{"loss": the losses so far,
    "group:name": a copy of the tensor}``."""
    eager, params, moms = build_train_step(batch=BATCH, device="cuda", net=net, dtype=dtype)
    aux = {n: p._tensor() for n, p in net.collect_params().items() if p.is_aux}
    losses, states = [], []
    for _ in range(steps):
        losses.append(eager(x, y))
        state = {"loss": torch.stack(losses)}
        for n, w in params.items():
            state[f"param:{n[cut:]}"] = w.detach().clone()
            state[f"mom:{n[cut:]}"] = moms[n].clone()
        for n, t in aux.items():
            state[f"aux:{n[cut:]}"] = t.detach().clone()
        states.append(state)
    return states


def _eager_state(build_train_step, net, x, y, dtype, cut):
    """The state after ``ND_STEPS`` eager steps (``_eager_states``)."""
    return _eager_states(build_train_step, net, x, y, dtype, cut)[-1]


def _nd_default_algorithms(mx, build_train_step, st):
    """``slice_nd`` again under cuDNN's default algorithm choice (not
    deterministic), as ``timing_nd`` and users run: two eager steps from
    the same state against each other, and the mx.nd program against the
    eager step.  Readings only: each group's worst tensor, its max |err|
    over its scale.  The bit-for-bit gate stays with the deterministic
    run."""
    prog, nd = st["prog"], mx.nd
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    out = {}
    try:
        for dtype in ("float32", "bfloat16"):
            want = _eager_state(build_train_step, copy.deepcopy(st["net"]), st["x"], st["y"],
                                dtype, st["cut"])
            again = _eager_state(build_train_step, copy.deepcopy(st["net"]), st["x"], st["y"],
                                 dtype, st["cut"])
            P, M = prog.make_state(nd, st["arrays"], st["specs"], torch.device("cuda", 0))
            if dtype == "bfloat16":
                mx.amp.init(target_dtype="bfloat16")
            try:
                losses = [prog.train_step(nd, mx.autograd, P, M, st["xn"], st["yn"],
                                          st["layers"], st["channels"])._data
                          for _ in range(ND_STEPS)]
            finally:
                mx.amp.deinit()
            got = _nd_results(P, M, torch.stack(losses), st["specs"])
            out[dtype] = {"eager_vs_eager": _nd_compare(again, want)[0],
                          "nd_vs_eager": _nd_compare(got, want)[0]}
    finally:
        torch.backends.cudnn.deterministic = saved
    emit("slice_nd_default_algorithms", model="resnet50_v1", batch=BATCH, image=IMAGE,
         steps=ND_STEPS, cudnn_deterministic=False, **out)
    return out


def _slice_nd(mx, library, vision, Xavier, build_train_step):
    prog = _nd_program()
    nd, gpu = mx.nd, torch.device("cuda", 0)
    layers, channels = [3, 4, 6, 3], [64, 256, 512, 1024, 2048]
    specs = prog.param_specs(layers, channels, 1000)
    net = resnet50(vision, Xavier, 0)
    cut = len(net.prefix)
    if [n[cut:] for n in net.collect_params()] != [s[0] for s in specs]:
        raise RuntimeError("the mx.nd program's parameters are not resnet50_v1's")
    arrays = {n[cut:]: p._tensor().detach().numpy() for n, p in net.collect_params().items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    xn, yn = nd.from_dlpack(x), nd.from_dlpack(y)
    steps, launches, invokes, out = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        P, M = prog.make_state(nd, arrays, specs, gpu)

        def nd_step(P=P, M=M, dtype=dtype):
            if dtype == "bfloat16":
                mx.amp.init(target_dtype="bfloat16")
            try:
                return prog.train_step(nd, mx.autograd, P, M, xn, yn, layers, channels)
            finally:
                mx.amp.deinit()

        torch.cuda.synchronize()
        calls = mx.nd.invoke.calls
        library.reset_launches()
        t0 = time.perf_counter()
        losses = [nd_step()._data for _ in range(ND_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[dtype] = {name: k.launches for name, k in library.KERNELS.items()}
        invokes[dtype] = (mx.nd.invoke.calls - calls) // ND_STEPS
        if launches[dtype] != {**{k: 0 for k in launches[dtype]}, "softmax_ce": ND_STEPS}:
            raise RuntimeError(f"slice_nd {dtype}: launches {launches[dtype]}, softmax_ce "
                               f"must launch once a step and nothing else")
        want = _eager_state(build_train_step, copy.deepcopy(net), x, y, dtype, cut)
        got = _nd_results(P, M, torch.stack(losses), specs)
        readings, failed = _nd_compare(got, want)
        out[dtype] = {"seconds": seconds, "launches": launches[dtype],
                      "invokes_per_step": invokes[dtype], **readings}
        if failed:
            emit("slice_nd", model="resnet50_v1", failed=failed, **out)
            raise RuntimeError(f"slice_nd {dtype}: {len(failed)} tensors differ from the "
                               f"eager step's: {failed[:8]}")
        steps[dtype] = nd_step
    emit("slice_nd", model="resnet50_v1", batch=BATCH, image=IMAGE, steps=ND_STEPS,
         cudnn_deterministic=True,
         trainable_params=sum(int(np.prod(s)) for _n, s, t in specs if t),
         program="tests/torch_nd_resnet.py", **out)
    state = {"prog": prog, "net": net, "arrays": arrays, "specs": specs, "x": x, "y": y,
             "xn": xn, "yn": yn, "cut": cut, "layers": layers, "channels": channels}
    return steps, launches, invokes, state


# slice_gluon: the gluon training surface at full width, held to
# build_train_step's eager step from one .params file under cuDNN's
# deterministic algorithms.  The two paths run different loss arithmetic
# (log_softmax + pick against the softmax_ce kernel), so the loss gradients
# part by rounding.  The first step's forward is the same on both, and its
# backward is linear in that gradient, so after step 1 fp32 holds every
# parameter, momentum and BatchNorm statistic within GLUON_F32_REL of its
# scale, and each update (w1 - w0) within GLUON_F32_REL of the eager
# update's own scale plus two f32 roundings of the weight (as
# ``_update_close``).  The second step's forward starts from weights that
# part by rounding, a ReLU or a max pool decides the other way here and
# there, and the gradients part by up to a tenth of a momentum: two eager
# steps under cuDNN's default algorithms part as much
# (``slice_nd_default_algorithms``, PERF.md).  So step 2 is held only in its
# losses (each within GLUON_F32_LOSS_REL) and in its update (w2 - w1) over
# every parameter in the 2-norm, within GLUON_F32_STEP2_REL: that catches a
# step that is missing or scaled; the groups' errors are readings.  bf16
# holds every tensor after each step bit-equal to the eager step's, and the
# losses within GLUON_BF16_LOSS_REL.
GLUON_STEPS = 2
GLUON_F32_REL = 1e-4
GLUON_F32_LOSS_REL = 1e-5
GLUON_F32_STEP2_REL = 0.1
GLUON_BF16_LOSS_REL = 1e-6
GLUON_SCHEDULE = {"step": 2, "factor": 0.5}   # first decay at update 3
# slice_gluon_kernels: a gluon MLP block with a LayerNorm at the transformer
# path's (8192, 768), trained by Adam; and one channels-last Conv2D + MaxPool2D
# at ResNet-50's stage-1 widths against its channels-first twin
GLUON_LN = {"rows": 8192, "embed": 768, "hidden": 3072, "steps": 2}
GLUON_NHWC = {"batch": 32, "size": 56, "channels": 64}
GLUON_NHWC_TOL = 1e-4


class _OpCounter:
    """Counts the calls of one registry op while it is entered."""

    def __init__(self, mx, name):
        self.op, self.calls = mx.ops.get(name), 0

    def __enter__(self):
        real = self.op.fcompute

        def counting(attrs, *args):
            self.calls += 1
            return real(attrs, *args)

        self.real, self.op.fcompute = real, counting
        return self

    def __exit__(self, *exc):
        self.op.fcompute = self.real


def _gluon_trainer(mx, net, x, y, dtype):
    """``(step, trainer, accuracy)``: ``step()`` runs one gluon step on the
    NDArrays ``x``, ``y`` (``record()``, SoftmaxCrossEntropyLoss,
    ``backward``, ``Trainer('sgd').step``, the Accuracy update) and
    returns the loss NDArray."""
    sched = mx.lr_scheduler.FactorScheduler(**GLUON_SCHEDULE)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": SGD["lr"], "momentum": SGD["momentum"], "wd": SGD["wd"],
        "lr_scheduler": sched})
    loss_fn, acc = mx.gluon.loss.SoftmaxCrossEntropyLoss(), mx.metric.Accuracy()

    def step():
        if dtype == "bfloat16":
            mx.amp.init(target_dtype="bfloat16")
        try:
            with mx.autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
        finally:
            mx.amp.deinit()
        trainer.step(BATCH)
        acc.update([y], [out])
        return loss

    return step, trainer, acc


def _gluon_state(net, trainer, losses):
    """``{"loss": tensor, "group:name": a copy of the tensor}`` of a gluon
    run, by MXNet name less the net's prefix, as ``_eager_states`` keys
    the eager step's."""
    cut = len(net.prefix)
    out = {"loss": torch.stack([loss._data.mean() for loss in losses])}
    for name, p in net.collect_params().items():
        out[f"{'aux' if p.is_aux else 'param'}:{name[cut:]}"] = p._tensor().detach().clone()
    for i, state in trainer._updaters[0].states.items():
        out[f"mom:{trainer._params[i].name[cut:]}"] = state._data.clone()
    return out


def _update_errs(got, want, old):
    """``{name: (max |err| over the update's scale, max |err| over its
    bound)}`` of each update
    ``got - old`` against ``want - old``: within GLUON_F32_REL of the eager
    update's largest magnitude (its group's for a zero-gradient bias,
    ZERO_GRAD_TENSOR, or a zero update) plus two f32 roundings of the
    weight, as ``_update_close`` holds the mesh phases' updates."""
    ups = {k: want[k].double() - old[k].double() for k in want}
    group_scale = max(u.abs().max().item() for u in ups.values())
    out = {}
    for k, up in ups.items():
        scale = up.abs().max().item()
        if ZERO_GRAD_TENSOR.match(k) or scale == 0.0:
            scale = group_scale
        err = (got[k].double() - old[k].double() - up).abs()
        rounding = 2 * torch.finfo(torch.float32).eps * torch.maximum(
            old[k].double().abs(), want[k].double().abs())
        out[k] = (err.max().item() / scale,
                  (err / (GLUON_F32_REL * scale + rounding)).max().item())
    return out


def _hold_gluon(got, want, w0, dtype):
    """Readings of the gluon state after each step (``got[i]``) against the
    eager one (``want[i]``), from the weights ``w0``, and the checks that
    failed (see GLUON_F32_REL)."""
    got_g, want_g = [_groups(s) for s in got], [_groups(s) for s in want]
    last = len(got) - 1
    loss_err = max(((got[last]["loss"] - want[last]["loss"]).abs()
                    / want[last]["loss"].abs()).tolist())
    steps, failed = [], []
    for i, (gg, wg) in enumerate(zip(got_g, want_g)):
        worst, norms = {}, {}
        for g, tensors in wg.items():
            if g == "loss":
                continue
            errs = _tensor_errs(gg[g], tensors)
            k = max(errs, key=errs.get)
            worst[g] = {"tensor": k, "max_err_over_scale": errs[k]}
            norms[g] = _group_rel_err(gg[g], tensors)
            if dtype == "bfloat16":
                failed += [f"step {i + 1} {k}" for k in tensors
                           if not torch.equal(gg[g][k], tensors[k])]
            elif i == 0:
                failed += [f"step 1 {k}" for k, e in errs.items() if e > GLUON_F32_REL]
        steps.append({"group_rel_err_2norm": norms, "worst_tensor": worst})
    readings = {"loss_rel_err": loss_err, "steps": steps}
    if dtype == "bfloat16":
        readings["tolerance"] = {"loss": GLUON_BF16_LOSS_REL, "tensors": "bit for bit"}
        if loss_err > GLUON_BF16_LOSS_REL:
            failed.append("loss")
        return readings, failed
    ups = _update_errs(got_g[0]["param"], want_g[0]["param"], w0)
    k = max(ups, key=lambda n: ups[n][1])
    failed += [f"step 1 update {n}" for n, (_e, over) in ups.items() if over > 1.0]
    step2 = _group_rel_err({n: got_g[1]["param"][n] - got_g[0]["param"][n]
                            for n in want_g[1]["param"]},
                           {n: want_g[1]["param"][n] - want_g[0]["param"][n]
                            for n in want_g[1]["param"]})
    if step2 > GLUON_F32_STEP2_REL:
        failed.append("step 2 update")
    if loss_err > GLUON_F32_LOSS_REL:
        failed.append("loss")
    # the control: dropping weight decay moves a first momentum by
    # lr * wd * |w0|, which must exceed the bound somewhere
    mom1 = want_g[0]["mom"]
    wd_share = max(SGD["lr"] * SGD["wd"] * w0["param" + n[3:]].abs().max().item()
                   / max(t.abs().max().item(), 1e-30)
                   for n, t in mom1.items() if not ZERO_GRAD_TENSOR.match(n))
    readings.update({
        "tolerance": {"step1_tensor_over_scale": GLUON_F32_REL, "loss": GLUON_F32_LOSS_REL,
                      "step1_update_over_update_scale": GLUON_F32_REL,
                      "step2_update_2norm": GLUON_F32_STEP2_REL},
        "step1_update_worst": {"tensor": k, "max_err_over_update_scale": ups[k][0],
                               "max_err_over_bound": ups[k][1]},
        "step2_update_rel_err_2norm": step2,
        "control_weight_decay_term_over_mom_scale": wd_share})
    return readings, failed


def run_slice_gluon(mx, vision, Xavier, build_train_step, library):
    """Full-width ResNet-50 v1 from ``vision.resnet50_v1()`` with deferred
    shapes (no ``in_channels``), batch 32, 224x224, 1000 classes, seed 0,
    saved to a ``.params`` file; then ``GLUON_STEPS`` gluon steps in fp32
    and in bf16 AMP from that file (``_gluon_trainer``), each held to
    ``build_train_step``'s eager step from the same file, under cuDNN's
    deterministic algorithms.  Returns the gluon steps (for
    ``timing_gluon``) and the ``multi_sgd_mom_update`` calls a step."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _slice_gluon(mx, vision, Xavier, build_train_step, library)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _slice_gluon(mx, vision, Xavier, build_train_step, library):
    gpu = mx.gpu(0)
    src = vision.resnet50_v1()
    src.initialize(Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    with mx.autograd.pause():
        src(mx.nd.from_dlpack(x[:1].clone()))          # deferred shapes, on the card
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                        "_build", "slice_gluon.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    src.save_parameters(path)
    cut = len(src.prefix)
    w0 = _groups({f"param:{n[cut:]}": p._tensor() for n, p in src.collect_params().items()
                  if not p.is_aux})["param"]
    xn, yn = mx.nd.from_dlpack(x), mx.nd.from_dlpack(y.float())
    steps, out, calls = {}, {}, {}
    try:
        for dtype in ("float32", "bfloat16"):
            net = vision.resnet50_v1()
            net.load_parameters(path, ctx=gpu)
            step, trainer, acc = _gluon_trainer(mx, net, xn, yn, dtype)
            torch.cuda.synchronize()
            library.reset_launches()
            losses, got, seconds = [], [], 0.0
            with _OpCounter(mx, "multi_sgd_mom_update") as counter:
                for _ in range(GLUON_STEPS):
                    t0 = time.perf_counter()
                    losses.append(step())
                    torch.cuda.synchronize()
                    seconds += time.perf_counter() - t0
                    got.append(_gluon_state(net, trainer, losses))
            launches = {name: k.launches for name, k in library.KERNELS.items()}
            if any(launches.values()):
                raise RuntimeError(f"slice_gluon {dtype}: a kernel launched: {launches}")
            trainable = [p for p in trainer._params if p.grad_req != "null"]
            calls[dtype] = counter.calls // GLUON_STEPS
            if calls[dtype] != math.ceil(len(trainable) / trainer.optimizer.aggregate_num):
                raise RuntimeError(f"slice_gluon {dtype}: {calls[dtype]} multi_sgd_mom_update "
                                   f"calls a step for {len(trainable)} trainable tensors")
            enet = vision.resnet50_v1()
            enet.load_parameters(path, ctx=gpu)
            want = _eager_states(build_train_step, enet, x, y, dtype, len(enet.prefix),
                                 GLUON_STEPS)
            if sorted(got[-1]) != sorted(want[-1]):
                raise RuntimeError(f"slice_gluon: the gluon state's tensors are not the "
                                   f"eager step's: {sorted(set(got[-1]) ^ set(want[-1]))[:4]}")
            readings, failed = _hold_gluon(got, want, w0, dtype)
            finite = all(torch.isfinite(t).all().item() for t in got[-1].values())
            out[dtype] = {"seconds": seconds, "losses": got[-1]["loss"].tolist(),
                          "eager_losses": want[-1]["loss"].tolist(),
                          "multi_sgd_mom_update_calls_per_step": calls[dtype],
                          "trainable_tensors": len(trainable),
                          "aggregate_num": trainer.optimizer.aggregate_num,
                          "accuracy": acc.get()[1], "learning_rate_after": trainer.learning_rate,
                          "finite": finite, **readings}
            if failed or not finite:
                emit("slice_gluon", model="resnet50_v1", failed=failed, **out)
                raise RuntimeError(f"slice_gluon {dtype}: {len(failed)} checks past their "
                                   f"bounds: {failed[:8]}")
            steps[dtype] = step
    finally:
        os.remove(path)
    emit("slice_gluon", model="resnet50_v1 (deferred shapes)", batch=BATCH, image=IMAGE,
         classes=1000, steps=GLUON_STEPS, cudnn_deterministic=True,
         optimizer={"sgd": SGD, "lr_scheduler": {"FactorScheduler": GLUON_SCHEDULE}},
         loss="SoftmaxCrossEntropyLoss (log_softmax + pick)", **out)
    return steps, calls


def run_slice_gluon_kernels(mx, library, fused_layer_norm):
    """``HybridSequential(Dense(3072), LayerNorm(), Dense(768))`` with
    deferred shapes at (8192, 768) f32, ``GLUON_LN["steps"]`` steps of
    ``Trainer('adam')`` under ``record()`` on an L2 loss: the layernorm
    kernel launches once a forward, and the LayerNorm layer's output equals
    ``fused_layer_norm`` on the same tensors bit for bit.  Then one
    channels-last ``Conv2D`` + ``MaxPool2D`` against its channels-first twin
    on permuted tensors, forward and backward, within GLUON_NHWC_TOL of
    each tensor's scale (TF32 off).  Returns the layernorm launches."""
    gpu, nn = mx.gpu(0), mx.gluon.nn
    c = GLUON_LN
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(c["hidden"], flatten=False), nn.LayerNorm(),
                nn.Dense(c["embed"], flatten=False))
    net.initialize(mx.init.Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = mx.nd.from_dlpack(torch.randn(c["rows"], c["embed"], generator=gen, device="cuda"))
    target = mx.nd.from_dlpack(torch.randn(c["rows"], c["embed"], generator=gen,
                                           device="cuda"))
    net.infer_shape(x)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    loss_fn = mx.gluon.loss.L2Loss()
    seen = []
    hook = net[1].register_forward_hook(lambda blk, inp, out: seen.append(
        (inp[0].detach(), out.detach(), blk.gamma.detach().clone(), blk.beta.detach().clone())))
    torch.cuda.synchronize()
    library.reset_launches()
    losses = []
    for _ in range(c["steps"]):
        with mx.autograd.record():
            loss = loss_fn(net(x), target)
        loss.backward()
        trainer.step(c["rows"])
        losses.append(float(loss.mean().asscalar()))
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    hook.detach()
    inp, out, gamma, beta = seen[-1]      # as the last forward read them
    with torch.no_grad():
        ref = fused_layer_norm(inp, gamma, beta, eps=1e-5)
    bitwise = torch.equal(out, ref)
    want = {**{k: 0 for k in launches}, "layernorm": c["steps"]}
    emit("slice_gluon_kernels", block="HybridSequential(Dense(3072), LayerNorm(), Dense(768))",
         shape=[c["rows"], c["embed"]], optimizer="adam", steps=c["steps"], losses=losses,
         launches=launches, layernorm_equals_fused_layer_norm=bitwise,
         channels_last=_gluon_nhwc(mx))
    if launches != want:
        raise RuntimeError(f"slice_gluon_kernels: launches {launches}, want {want}")
    if not bitwise:
        raise RuntimeError("slice_gluon_kernels: the LayerNorm layer's output is not "
                           "fused_layer_norm's")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"slice_gluon_kernels: losses {losses}")
    return launches


def _gluon_nhwc(mx):
    """A channels-last ``Conv2D`` and ``MaxPool2D`` against their
    channels-first twins on permuted tensors, forward and backward, each
    layer on its own input: a max pool's backward sends each window's
    gradient to its largest input, so two convolutions' outputs that part
    by rounding could send it to another element."""
    nn, gpu, c = mx.gluon.nn, mx.gpu(0), GLUON_NHWC
    gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {}

    def hold(name, first, last, with_weight):
        x = torch.randn(c["batch"], c["channels"], c["size"], c["size"], generator=gen,
                        device="cuda")
        xl = x.permute(0, 2, 3, 1).contiguous()
        first.initialize(mx.init.Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(4))
        last.initialize(ctx=gpu)
        first.infer_shape(x)
        last.infer_shape(xl)
        for (k, pa), pb in zip(first.collect_params().items(), last.collect_params().values()):
            t = pa._tensor().detach()
            pb.set_data(t.permute(2, 3, 1, 0).contiguous() if k.endswith("weight") else t)
        x.requires_grad_(True)
        xl.requires_grad_(True)
        ya, yb = first(x), last(xl)
        head = torch.randn(ya.shape, generator=gen, device="cuda")
        ya.backward(head)
        yb.backward(head.permute(0, 2, 3, 1))
        pairs = {"output": (yb, ya.permute(0, 2, 3, 1)),
                 "input_gradient": (xl.grad, x.grad.permute(0, 2, 3, 1))}
        if with_weight:
            pairs["weight_gradient"] = (last.weight.grad, first.weight.grad.permute(2, 3, 1, 0))
            pairs["bias_gradient"] = (last.bias.grad, first.bias.grad)
        errs[name] = {k: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                      for k, (a, b) in pairs.items()}

    hold("Conv2D(64, 3, padding=1)", nn.Conv2D(c["channels"], 3, padding=1, layout="NCHW"),
         nn.Conv2D(c["channels"], 3, padding=1, layout="NHWC"), True)
    hold("MaxPool2D(3, 2, 1)", nn.MaxPool2D(3, 2, 1, layout="NCHW"),
         nn.MaxPool2D(3, 2, 1, layout="NHWC"), False)
    xl = torch.zeros(1, c["size"], c["size"], c["channels"], device="cuda")
    reading = {"shape_nhwc": [c["batch"], c["size"], c["size"], c["channels"]],
               "reaches_cudnn_channels_last":
                   xl.movedim(-1, 1).is_contiguous(memory_format=torch.channels_last),
               "max_err_over_scale": errs, "tolerance": GLUON_NHWC_TOL}
    worst = max(e for layer in errs.values() for e in layer.values())
    if worst > GLUON_NHWC_TOL:
        emit("slice_gluon_kernels", failed="channels_last", channels_last=reading)
        raise RuntimeError(f"slice_gluon_kernels: NHWC against NCHW {errs}")
    return reading


# -- hybridize, and the symbol path through Module ---------------------------------
# slice_hybridize: slice_gluon's ResNet-50 and steps, hybridized, against the
# same steps not hybridized (bit for bit: the same kernels on the same inputs)
HYBRID_STEPS = 2
# slice_module: bench.py's _resnet50_symbol through Module.fit, _module_steps'
# optimizer, one epoch of MODULE_BATCHES batches, from one saved state
MODULE_BATCHES = 4
MODULE_SGD = {"learning_rate": 0.01, "momentum": 0.9}
MODULE_SCAN = 2
# slice_module_kernels: data (64, 768) -> FullyConnected(768) -> LayerNorm ->
# FullyConnected(1000) -> MakeLoss(softmax_cross_entropy(fc, label))
MODULE_KERNELS = {"rows": 64, "embed": 768, "classes": 1000, "batches": 3}
MODULE_KERNELS_TOL = 2e-5       # softmax_ce's and layernorm's f32 gate


def _test_helper(name):
    """The module ``tests/<name>.py`` (a test helper that imports no JAX)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import importlib
    return importlib.import_module(name)


def _symbol_resnet():
    """``tests/torch_symbol_resnet.py``, bench's ``_resnet50_symbol``."""
    return _test_helper("torch_symbol_resnet")


class _Env:
    """Set environment knobs while entered, and put them back."""

    def __init__(self, **knobs):
        self.knobs, self.saved = knobs, {}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _deterministic(fn, *args):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn(*args)
    finally:
        torch.backends.cudnn.deterministic = saved


def _bit_diff(got, want):
    """The names whose tensors are not equal bit for bit."""
    return [k for k in want if not torch.equal(got[k], want[k])]


def run_slice_hybridize(mx, vision, Xavier, library):
    """``slice_gluon``'s full-width ResNet-50 v1 (deferred shapes, one
    ``.params`` file, ``Trainer('sgd')`` with its schedule), ``HYBRID_STEPS``
    steps in fp32 and in bf16 AMP with the net hybridized, held bit for bit
    to the same steps of the same net not hybridized, under cuDNN's
    deterministic algorithms: losses, parameters, momenta and BatchNorm
    statistics.  One capture a key (the recording call's), replays after.
    Returns the hybridized steps (for ``timing_hybridize``)."""
    return _deterministic(_slice_hybridize, mx, vision, Xavier, library)


def _slice_hybridize(mx, vision, Xavier, library):
    gpu = mx.gpu(0)
    src = vision.resnet50_v1()
    src.initialize(Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    with mx.autograd.pause():
        src(mx.nd.from_dlpack(x[:1].clone()))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                        "_build", "slice_hybridize.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    src.save_parameters(path)
    xn, yn = mx.nd.from_dlpack(x), mx.nd.from_dlpack(y.float())
    steps, out = {}, {}
    try:
        for dtype in ("float32", "bfloat16"):
            runs = {}
            for hybrid in (False, True):
                net = vision.resnet50_v1()
                net.load_parameters(path, ctx=gpu)
                if hybrid:
                    net.hybridize()
                step, trainer, _acc = _gluon_trainer(mx, net, xn, yn, dtype)
                torch.cuda.synchronize()
                library.reset_launches()
                losses, seconds = [], []
                for _ in range(HYBRID_STEPS):
                    t0 = time.perf_counter()
                    losses.append(step())
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t0)
                runs[hybrid] = (net, _gluon_state(net, trainer, losses), seconds, step)
            net, got, seconds, step = runs[True]
            want = runs[False][1]
            differ = _bit_diff(got, want)
            keys = {str(k[1:3]): {"replays": e.replays} for k, e in net._cached.items()}
            out[dtype] = {"losses": got["loss"].tolist(), "eager_losses": want["loss"].tolist(),
                          "tensors": len(want), "not_bit_equal": differ[:8],
                          "captures": len(net._cached),
                          "keys_is_training_is_recording": keys,
                          "seconds_per_step": seconds,
                          "eager_seconds_per_step": runs[False][2]}
            if differ or len(net._cached) != 1 or \
                    next(iter(net._cached.values())).replays != HYBRID_STEPS:
                emit("slice_hybridize", failed=dtype, **out)
                raise RuntimeError(f"slice_hybridize {dtype}: {len(differ)} tensors differ "
                                   f"({differ[:4]}), captures {keys}")
            # timing_hybridize captures anew, under cuDNN's default algorithms
            net._clear_cached_op()
            steps[dtype] = step
    finally:
        os.remove(path)
    emit("slice_hybridize", model="resnet50_v1 (deferred shapes), hybridized", batch=BATCH,
         image=IMAGE, steps=HYBRID_STEPS, cudnn_deterministic=True,
         held="bit for bit to the same steps not hybridized", **out)
    return steps


def _step_losses(mx):
    """An EvalMetric that keeps each batch's mean cross-entropy of the
    softmax outputs in ``values``, computed on the card
    (``Module.update_metric`` feeds it)."""

    class StepLosses(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("step_losses")
            self.values = []

        def update(self, labels, preds):
            p, label = (torch.as_tensor(getattr(a, "_data", a), device="cuda")
                        for a in (preds[0], labels[0]))
            self.values.append(-p.gather(1, label.long().reshape(-1, 1)).clamp_min(1e-30)
                               .log().mean())

    return StepLosses()


def _module_state(mod):
    """``{"param:name" / "aux:name" / "mom:name": a copy}`` of a Module."""
    ex = mod._exec
    out = {f"param:{n}": ex.arg_dict[n]._data.clone() for n in mod._param_names}
    out.update({f"aux:{n}": ex.aux_dict[n]._data.clone() for n in mod._aux_names})
    for i, st in mod._updater.states.items():
        out[f"mom:{mod._param_names[i]}"] = st._data.clone()
    return out


def _module_fit(mx, symbol, x, y, params, knobs, batch, metric, callback=None):
    """One epoch of ``Module.fit`` over ``x``, ``y`` (host arrays) under the
    environment ``knobs``, from ``params`` = (arg_params, aux_params).
    Returns ``(module, fused flags of each update())``."""
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    flags = []
    with _Env(**knobs):
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params=params[0], aux_params=params[1])
        mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params=MODULE_SGD)
        update = mod.update

        def recorded_update():
            flags.append(mod._fused_step_done)
            update()

        mod.update = recorded_update
        mod.fit(it, num_epoch=1, eval_metric=metric, kvstore=None, optimizer="sgd",
                optimizer_params=MODULE_SGD, batch_end_callback=callback)
        torch.cuda.synchronize()
    return mod, flags


def run_slice_module(mx, Xavier, library):
    """bench.py's ``_resnet50_symbol(1000)`` at full width, batch 32, 224x224,
    fp32 (TF32 off), through ``Module.fit``: one epoch of an ``NDArrayIter``
    over ``MODULE_BATCHES`` batches, SGD with momentum 0.9 and lr 0.01, from
    one state made by ``Xavier()`` on seed 0 and saved with
    ``save_checkpoint``; three runs: ``MXNET_FUSED_STEP=1`` (one CUDA graph a
    step), ``MXNET_FUSED_STEP=0`` (the per-parameter loop) and
    ``MXNET_SCAN_STEPS=2`` (two windows of two), the fused and the scanned
    runs held to the loop bit for bit under cuDNN's deterministic
    algorithms (losses, parameters, momenta, BatchNorm statistics).
    Returns the three modules and a staged batch, for ``timing_module``,
    and the inputs and the fused and scanned runs' states and counts, for
    ``slice_numerics``."""
    return _deterministic(_slice_module, mx, Xavier, library)


def _module_inputs(mx, Xavier):
    """``slice_module``'s inputs: bench.py's ``_resnet50_symbol(1000)``,
    ``MODULE_BATCHES`` batches of host data and labels from seed 0, and
    (arg_params, aux_params) made by ``Xavier()`` on seed 0 and read back
    from a ``save_checkpoint`` file."""
    symbol = _symbol_resnet().resnet50_symbol(mx.sym, num_classes=1000)
    rng = np.random.RandomState(0)
    n = MODULE_BATCHES * BATCH
    x = rng.randn(n, 3, IMAGE, IMAGE).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    init = mx.mod.Module(symbol, context=mx.gpu(0))
    init.bind(data_shapes=[("data", (BATCH, 3, IMAGE, IMAGE))],
              label_shapes=[("softmax_label", (BATCH,))])
    torch.manual_seed(0)
    init.init_params(Xavier())
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                          "_build", "slice_module")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    init.save_checkpoint(prefix, 0)
    del init
    try:
        params = mx.model.load_params(prefix, 0)
    finally:
        for f in (f"{prefix}-symbol.json", f"{prefix}-0000.params"):
            os.remove(f)
    return symbol, x, y, params


def _slice_module(mx, Xavier, library):
    symbol, x, y, params = _module_inputs(mx, Xavier)
    runs = {"fused": {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 1},
            "loop": {"MXNET_FUSED_STEP": 0, "MXNET_SCAN_STEPS": 1},
            "scan": {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": MODULE_SCAN}}
    mods, states, out = {}, {}, {}
    for name, knobs in runs.items():
        metric = _step_losses(mx)
        library.reset_launches()
        mx.profiler.reset_dispatch_counts()
        t0 = time.perf_counter()
        mod, flags = _module_fit(mx, symbol, x, y, params, knobs, BATCH, metric)
        seconds = time.perf_counter() - t0
        launches = {k: v.launches for k, v in library.KERNELS.items()}
        fs = mod._fused if name == "fused" else mod._scan
        states[name] = {"loss": torch.stack(metric.values), **_module_state(mod)}
        out[name] = {"knobs": knobs, "losses": states[name]["loss"].tolist(),
                     "steps_fused": sum(flags), "updates": len(flags),
                     "captures": fs.captures if fs else 0, "replays": fs.replays if fs else 0,
                     "steps": fs.steps if fs else 0, "seconds": seconds,
                     "dispatches": mx.profiler.dispatch_counts(),
                     "kernel_launches": launches}
        mods[name] = mod
    want = states["loop"]
    failed = []
    for name in ("fused", "scan"):
        differ = _bit_diff(states[name], want)
        out[name]["not_bit_equal_to_loop"] = differ[:8]
        if differ:
            failed.append(f"{name}: {len(differ)} tensors differ from the loop ({differ[:4]})")
    f, s, lp = out["fused"], out["scan"], out["loop"]
    if f["steps_fused"] != MODULE_BATCHES or f["captures"] != 1 or \
            f["replays"] != MODULE_BATCHES:
        failed.append(f"fused: {f['steps_fused']} steps fused, {f['captures']} captures, "
                      f"{f['replays']} replays for {MODULE_BATCHES} batches")
    if lp["steps_fused"] != 0:
        failed.append("loop: a step ran fused")
    if s["captures"] != 1 or s["replays"] != MODULE_BATCHES // MODULE_SCAN or \
            s["steps"] != MODULE_BATCHES:
        failed.append(f"scan: {s['captures']} captures, {s['replays']} replays, "
                      f"{s['steps']} steps")
    finite = all(torch.isfinite(t).all().item() for t in want.values())
    emit("slice_module", model="bench.py _resnet50_symbol(1000)", batch=BATCH, image=IMAGE,
         batches=MODULE_BATCHES, optimizer={"sgd": MODULE_SGD}, init="Xavier(), seed 0",
         cudnn_deterministic=True, tensors=len(want), finite=finite, failed=failed,
         held="fused and scan against loop, bit for bit", **out)
    if failed or not finite:
        raise RuntimeError(f"slice_module: {failed or 'non-finite state'}")
    it = mx.io.NDArrayIter(x[:BATCH * MODULE_SCAN], y[:BATCH * MODULE_SCAN],
                           batch_size=BATCH)
    batches = [b for b in it]
    staged = [mx.io.stage_batch(b, mx.gpu(0)) for b in batches]
    sbatch = mx.io.stage_super_batch(batches, mx.gpu(0))
    # slice_numerics holds its armed runs to these states and counts
    off = {name: {"state": states[name], **out[name]} for name in ("fused", "scan")}
    return mods, staged[0], sbatch, (symbol, x, y, params), off


def _kernels_symbol(mx):
    c = MODULE_KERNELS
    sym = mx.sym
    data, label = sym.Variable("data"), sym.Variable("softmax_label")
    fc1 = sym.FullyConnected(data, num_hidden=c["embed"], name="fc1")
    ln = sym.LayerNorm(fc1, name="ln")
    fc2 = sym.FullyConnected(ln, num_hidden=c["classes"], name="fc2")
    return sym.MakeLoss(sym.softmax_cross_entropy(fc2, label), name="loss")


def _kernels_inputs(mx):
    """``slice_module_kernels``' narrow symbol, its host data and labels, and
    its weights (from seed 5; LayerNorm's gamma ones)."""
    c = MODULE_KERNELS
    symbol = _kernels_symbol(mx)
    rng = np.random.RandomState(5)
    n = c["batches"] * c["rows"]
    x = rng.randn(n, c["embed"]).astype(np.float32)
    y = rng.randint(0, c["classes"], n).astype(np.float32)
    shapes = symbol.infer_shape(data=(c["rows"], c["embed"]),
                                softmax_label=(c["rows"],))[0]
    args = {k: mx.nd.array(rng.randn(*s).astype(np.float32) * 0.05, ctx=mx.cpu())
            for k, s in zip(symbol.list_arguments(), shapes)
            if k not in ("data", "softmax_label")}
    args["ln_gamma"] = mx.nd.ones(args["ln_gamma"].shape, ctx=mx.cpu())
    return symbol, x, y, args


def _plain_kernels_loss(params, x, y):
    """The narrow symbol's loss by the plain versions of the kernels."""
    from mxnet_tpu_torch.ops.layer_norm import plain_layer_norm
    from mxnet_tpu_torch.ops.softmax_ce import plain_softmax_ce
    p = {k: v._data for k, v in params.items()}
    h = torch.nn.functional.linear(x, p["fc1_weight"], p["fc1_bias"])
    h = plain_layer_norm(h, p["ln_gamma"], p["ln_beta"], eps=1e-5)
    h = torch.nn.functional.linear(h, p["fc2_weight"], p["fc2_bias"])
    return plain_softmax_ce(h, y).sum()


def run_slice_module_kernels(mx, library, fused_layer_norm):
    """The narrow symbol of ``MODULE_KERNELS`` through ``Module.fit``, loop
    and fused, ``batches`` batches each: layernorm and softmax_ce launch once
    a step in the loop, and in the fused run only at the capture's warm-up
    and capture (``CAPTURE_WARMUP`` + 1), never at a replay; the two runs
    bit-equal, and the loop's first loss held to the plain versions at
    ``MODULE_KERNELS_TOL``.  Then a hybridized ``HybridSequential(Dense,
    LayerNorm, Dense)``: its layernorm launches at the capture only, and its
    output and gradients equal the same Block not hybridized, bit for bit.
    Returns the launches by path."""
    from mxnet_tpu_torch.train_step import CAPTURE_WARMUP
    c = MODULE_KERNELS
    symbol, x, y, args = _kernels_inputs(mx)
    names = [k for k in library.KERNELS if k in ("layernorm", "softmax_ce")]
    runs, out = {}, {}
    for name, fused in (("loop", 0), ("fused", 1)):
        per_batch = []
        metric = mx.metric.Loss()
        library.reset_launches()
        mod, flags = _module_fit(
            mx, symbol, x, y, (args, {}), {"MXNET_FUSED_STEP": fused, "MXNET_SCAN_STEPS": 1},
            c["rows"], metric,
            callback=lambda p: per_batch.append(
                {k: library.KERNELS[k].launches for k in names}))
        state = _module_state(mod)
        runs[name] = state
        out[name] = {"launches_after_each_batch": per_batch, "steps_fused": sum(flags),
                     "loss_mean": metric.get()[1]}
    with torch.no_grad():
        plain = _plain_kernels_loss({k: mx.nd.array(v.asnumpy(), ctx=mx.gpu(0))
                                     for k, v in args.items()},
                                    torch.from_numpy(x[:c["rows"]]).cuda(),
                                    torch.from_numpy(y[:c["rows"]]).cuda())
        # the loop's first step from the same weights, its loss output read directly
        ex_mod = mx.mod.Module(symbol, context=mx.gpu(0))
        ex_mod.bind(data_shapes=[("data", (c["rows"], c["embed"]))],
                    label_shapes=[("softmax_label", (c["rows"],))], for_training=False)
        ex_mod.init_params(arg_params=args)
        ex_mod.forward(mx.io.DataBatch([mx.nd.array(x[:c["rows"]], ctx=mx.cpu())],
                                       [mx.nd.array(y[:c["rows"]], ctx=mx.cpu())]),
                       is_train=False)
        got = ex_mod.get_outputs()[0]._data.float().sum()
    loss_err = ((got - plain).abs() / plain.abs()).item()
    differ = _bit_diff(runs["fused"], runs["loop"])
    want_loop = [{k: i + 1 for k in names} for i in range(c["batches"])]
    want_fused = [{k: CAPTURE_WARMUP + 1 for k in names}] * c["batches"]
    hybrid = _hybrid_kernels(mx, library, fused_layer_norm)
    failed = []
    if out["loop"]["launches_after_each_batch"] != want_loop:
        failed.append("loop launches")
    if out["fused"]["launches_after_each_batch"] != want_fused:
        failed.append("fused launches")
    if out["fused"]["steps_fused"] != c["batches"]:
        failed.append("fused steps")
    if differ:
        failed.append(f"fused against loop: {differ[:4]}")
    if loss_err > MODULE_KERNELS_TOL:
        failed.append(f"loss against the plain versions: {loss_err}")
    failed += hybrid.pop("failed")
    emit("slice_module_kernels",
         symbol="data (64, 768) -> FullyConnected(768) -> LayerNorm -> FullyConnected(1000) "
                "-> MakeLoss(softmax_cross_entropy)", batches=c["batches"],
         capture_warmup=CAPTURE_WARMUP, loss_rel_err_vs_plain=loss_err,
         tolerance=MODULE_KERNELS_TOL, fused_not_bit_equal_to_loop=differ[:8],
         hybridized=hybrid, failed=failed, **out)
    if failed:
        raise RuntimeError(f"slice_module_kernels: {failed}")
    return {"loop": out["loop"]["launches_after_each_batch"][-1],
            "fused": out["fused"]["launches_after_each_batch"][-1],
            "hybridize": hybrid["launches_after_each_call"][-1]}


def _hybrid_kernels(mx, library, fused_layer_norm):
    """``HybridSequential(Dense(3072), LayerNorm(), Dense(768))`` at (8192,
    768) f32 under ``record()``, twice hybridized and once not, from the same
    weights: output and gradients bit-equal, layernorm launches only at the
    first hybridized call (warm-up and capture)."""
    gpu, nn, c = mx.gpu(0), mx.gluon.nn, GLUON_LN

    def make():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(c["hidden"], flatten=False), nn.LayerNorm(),
                    nn.Dense(c["embed"], flatten=False))
        net.initialize(mx.init.Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(6))
        return net

    gen = torch.Generator(device="cuda").manual_seed(6)
    x = mx.nd.from_dlpack(torch.randn(c["rows"], c["embed"], generator=gen, device="cuda"))
    head = mx.nd.from_dlpack(torch.randn(c["rows"], c["embed"], generator=gen, device="cuda"))

    def call(net):
        with mx.autograd.record():
            y = net(x)
        y.backward(head)
        grads = {k: p.grad()._data.clone() for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        return y._data.clone(), grads

    plain = make()
    plain.infer_shape(x)
    want = call(plain)
    net = make()
    net.infer_shape(x)
    net.hybridize()
    library.reset_launches()
    seen, got = [], None
    for _ in range(2):
        got = call(net)
        seen.append(library.KERNELS["layernorm"].launches)
    from mxnet_tpu_torch.train_step import CAPTURE_WARMUP
    cut = len(net.prefix), len(plain.prefix)
    differ = [] if torch.equal(got[0], want[0]) else ["output"]
    differ += [k for k, g in got[1].items()
               if not torch.equal(g, want[1][plain.prefix + k[cut[0]:]])]
    failed = []
    if seen != [CAPTURE_WARMUP + 1] * 2:
        failed.append(f"hybridized layernorm launches {seen}")
    if differ:
        failed.append(f"hybridized against eager: {differ[:4]}")
    entry = next(iter(net._cached.values()))
    return {"block": "HybridSequential(Dense(3072), LayerNorm(), Dense(768))",
            "launches_after_each_call": seen, "not_bit_equal": differ,
            "captures": len(net._cached), "replays": entry.replays, "failed": failed}


def time_module(configs, step_ms):
    """``timing_module``: ms a step by CUDA events (``step_ms``, before the
    first profiler session) and, from a profiled repeat, the kernel launches
    a step and the device's idle share, for the fused step, the scanned
    window (per step: a window is ``MODULE_SCAN`` steps) and the loop,
    beside ``timing.configs``' fp32 captured ``build_train_step``; the
    method of ``bench.py`` ``measure_train_dispatch``."""
    timed = profile_step_configs(configs, step_ms)
    out = {}
    for name, t in timed.items():
        per = MODULE_SCAN if name == "module_scan" else 1
        launches = sum(k["calls_per_step"] for k in t["profile"]["by_kind"].values())
        out[name] = {"ms_per_step": step_ms[name] / per, "img_per_s": BATCH * per
                     / step_ms[name] * 1e3, "steps_per_call": per,
                     "kernel_launches_per_step": launches / per,
                     "device_idle_share_vs_step_ms": t["device_idle_share_vs_step_ms"],
                     "profile": t["profile"]}
    return {"steps": out, "build_train_step_fp32_graph_ms": step_ms["fp32_graph"],
            "build_train_step_fp32_eager_ms": step_ms["fp32_eager"]}


def time_module_configs(mx, mods, staged, sbatch):
    """``{name: fn}`` of one Module step for ``timing_module``: the fused step
    (a replay), the per-parameter loop, and a scanned window of
    ``MODULE_SCAN`` steps (its ms are per window).  The fused and scanned
    steps capture anew at their first call, under cuDNN's default
    algorithms (``slice_module`` captured them under deterministic ones)."""
    mods["fused"]._fused = None
    mods["scan"]._scan = None

    def fused():
        mods["fused"].forward_backward(staged)
        mods["fused"].update()

    def loop():
        with _Env(MXNET_FUSED_STEP=0):
            mods["loop"].forward_backward(staged)
            mods["loop"].update()

    def scan():
        mods["scan"]._run_scan_window(sbatch, (MODULE_SCAN, 1))

    return {"module_fused": fused, "module_loop": loop, "module_scan": scan}


def _nd_kernel_inputs(shape, dtype, seed, n=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(n)]


def run_nd_kernels(mx, library, fused_layer_norm, flash_attention):
    """``nd.LayerNorm`` at ``ND_LN_SHAPE`` f32 and ``nd.contrib.flash_attention``
    at ``ND_ATTN_SHAPE`` causal, f32 and bf16, each under ``record()`` with
    ``backward()`` through the marked inputs; launches counted over that
    run alone (layernorm 1, attention 2: one a forward).  Then the same
    kernels' autograd Functions called directly on the same inputs, with
    ``torch.autograd.grad``: outputs and gradients held bit for bit."""
    nd, ag = mx.nd, mx.autograd
    n, d = ND_LN_SHAPE
    x, ct = _nd_kernel_inputs((n, d), torch.float32, 31, 2)
    gamma, beta = (t[0] for t in _nd_kernel_inputs((1, d), torch.float32, 32, 2))
    qkv = {dt: _nd_kernel_inputs(ND_ATTN_SHAPE, dt, 33, 4)
           for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    library.reset_launches()
    ln_in = [nd.from_dlpack(t.clone()) for t in (x, gamma, beta)]
    for a in ln_in:
        a.attach_grad()
    with ag.record():
        y = nd.LayerNorm(*ln_in, axis=-1, eps=1e-5)
    y.backward(nd.from_dlpack(ct))
    attn = {}
    for dt, (q, k, v, g) in qkv.items():
        arrays = [nd.from_dlpack(t.clone()) for t in (q, k, v)]
        for a in arrays:
            a.attach_grad()
        with ag.record():
            o = nd.contrib.flash_attention(*arrays, causal=True)
        o.backward(nd.from_dlpack(g))
        attn[dt] = (o, arrays)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    want_launches = {**{k: 0 for k in launches}, "layernorm": 1, "attention": 2}
    checks = {}

    def hold(name, got, want):
        bitwise = [torch.equal(a, b) for a, b in zip(got, want)]
        err = max(_max_err(a, b) for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        checks[name] = {"bitwise": all(bitwise), "max_abs_err": err, "bound": 0.0,
                        "scale": scale}

    xs = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    y_ref = fused_layer_norm(xs[0], xs[1], xs[2], eps=1e-5)
    hold("layernorm_f32", [y._data.detach()] + [a.grad._data for a in ln_in],
         [y_ref.detach(), *torch.autograd.grad(y_ref, xs, ct)])
    for dt, (o, arrays) in attn.items():
        q, k, v, g = qkv[dt]
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o_ref = flash_attention(*ts, causal=True)
        hold(f"attention_{str(dt).split('.')[-1]}",
             [o._data.detach()] + [a.grad._data for a in arrays],
             [o_ref.detach(), *torch.autograd.grad(o_ref, ts, g)])
    emit("slice_nd_kernels", layernorm_shape=list(ND_LN_SHAPE),
         attention_shape=list(ND_ATTN_SHAPE), causal=True, launches=launches,
         outputs_and_gradients=checks)
    if launches != want_launches:
        raise RuntimeError(f"slice_nd kernels: launches {launches}, want {want_launches}")
    failed = [name for name, c in checks.items() if not c["bitwise"]]
    if failed:
        raise RuntimeError(f"slice_nd kernels: not bit for bit with the direct calls: {failed}")
    return launches


def time_nd_invoke(mx):
    """Host microseconds of one ``invoke`` (``nd.elemwise_add`` of two (1024,)
    f32 arrays on the card), recording off and on (the first input a
    marked variable, so a graph is built), beside ``torch.add`` on the same
    tensors; before the first profiler session."""
    nd, ag = mx.nd, mx.autograd
    a, b = (nd.from_dlpack(t) for t in _nd_kernel_inputs((1024,), torch.float32, 41, 2))
    var = nd.from_dlpack(a._data.clone())
    var.attach_grad()
    out = {"shape": [1024], "torch_add_us": host_us_per_call(lambda: torch.add(a._data, b._data)),
           "invoke_us": host_us_per_call(lambda: nd.elemwise_add(a, b))}
    with ag.record():
        out["invoke_recording_us"] = host_us_per_call(lambda: nd.elemwise_add(var, b))
        head = nd.elemwise_add(var, b).sum()
    head.backward()      # frees the recording
    return out


def time_step_configs(configs):
    """CUDA-event ms a step of each ``{name: fn}``, 10 calls after 2 of
    warm-up: before the first profiler session of the process."""
    return {name: cuda_ms(fn, iters=10, warmup=2) for name, fn in configs.items()}


def profile_step_configs(configs, step_ms):
    """Each configuration's profile (``step_breakdown``), its img/s and the
    device's idle share of its unprofiled step (busy time over ``step_ms``)."""
    out = {}
    for name, fn in configs.items():
        prof = step_breakdown(fn)
        busy = prof["device_busy_ms_per_step"]
        out[name] = {"step_ms": step_ms[name], "img_per_s": BATCH / step_ms[name] * 1e3,
                     "device_idle_share_vs_step_ms": 1.0 - busy / step_ms[name] if busy else None,
                     "profile": prof}
    return out


def host_us_per_call(fn, calls=1000, warmup=50):
    """Host microseconds a call of fn(): the wall time of ``calls`` calls
    without a synchronize, after warm-up, over ``calls``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def _smce_library(x, labels):
    import torch.nn.functional as F

    y64 = labels.long()

    def library():
        return (torch.softmax(x, dim=-1),
                F.cross_entropy(x, y64, reduction="none", ignore_index=-1))

    return library


def _smce_bound(n, d, dtype):
    """Least time of softmax_ce over (n, d): each input read once, each
    output written once (logits and int32 labels in; f32 loss and
    probabilities in the input dtype out) against 7 operations a logit
    (max; sub, exp, add; sub, exp, div)."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * n * d * size + n * 4 + n * 4
    ops = 7 * n * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


# the softmax_ce kernel at the path's (32, 1000): one warp a row, four a
# block (csrc/softmax_ce.cu kWarpRows)
SMCE_PATH_GRID, SMCE_PATH_BLOCK = (8, 1, 1), (128, 1, 1)
FLOOR_SRC = 'extern "C" __global__ void smce_floor() {}'


def launch_floor_device_ms(mx, rtc):
    """Device time of an empty kernel, compiled through mx.rtc, at the
    softmax_ce kernel's grid and block on the path: what any launch costs."""
    k = rtc.CudaModule(FLOOR_SRC).get_kernel("smce_floor", "")
    gpu = mx.gpu(0)
    return kernel_device_ms(lambda: k.launch([], gpu, SMCE_PATH_GRID, SMCE_PATH_BLOCK),
                            "smce_floor")["kernel_self_device_ms"]


def smce_path_inputs():
    return smce_inputs(BATCH, 1000, torch.float32, seed=7, padding=False)


def ln_path_inputs():
    n, d = GPT2_SMALL["batch"] * GPT2_SMALL["seq"], GPT2_SMALL["embed"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(n, d, generator=gen, device="cuda")
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    return x, gamma, beta


def _ln_library(x, gamma, beta):
    return lambda: torch.native_layer_norm(x, (x.shape[1],), gamma, beta, 1e-5)


def host_bound_times(entry, ln_entry):
    """CUDA-event times of softmax_ce's and layernorm's wrappers, their plain
    versions and library calls at their paths' shapes, and the host time a
    call of each wrapper and library call.  Taken before any torch.profiler
    session of the process: after one, the host runs these calls 1.5-2x
    slower for the rest of the process (PERF.md, Findings), and a call whose
    host time exceeds its device time is timed by its host."""
    x, labels = smce_path_inputs()
    kernel, library = (lambda: entry.kernel(x, labels)), _smce_library(x, labels)
    smce_t = {"ms": cuda_ms(kernel, iters=500, warmup=20),
              "plain_ms": cuda_ms(lambda: entry.plain(x, labels), iters=500, warmup=20),
              "library_ms": cuda_ms(library, iters=500, warmup=20),
              "host_us_per_call": host_us_per_call(kernel),
              "library_host_us_per_call": host_us_per_call(library)}
    xl, gamma, beta = ln_path_inputs()
    kernel, library = (lambda: ln_entry.kernel(xl, gamma, beta)), _ln_library(xl, gamma, beta)
    ln_t = {"ms": cuda_ms(kernel, iters=200, warmup=20),
            "plain_ms": cuda_ms(lambda: ln_entry.plain(xl, gamma, beta), iters=200, warmup=20),
            "library_ms": cuda_ms(library, iters=200, warmup=20),
            "host_us_per_call": host_us_per_call(kernel),
            "library_host_us_per_call": host_us_per_call(library)}
    return smce_t, ln_t


def time_softmax_ce(entry, mx, rtc, host):
    """``host`` (``host_bound_times``) with the device times at the main
    path's shape, the launch floor and the bound; and kernel, device and
    library times and the bound at the LM-head shape (GPT-2's vocabulary over
    the transformer slice's tokens) in f32 and bf16."""
    x, labels = smce_path_inputs()
    library = _smce_library(x, labels)
    out = {**host,
           **kernel_device_ms(lambda: entry.kernel(x, labels), "smce_kernel"),
           "library_device_ms": library_device_ms(library),
           "launch_floor_device_ms": launch_floor_device_ms(mx, rtc),
           "launch_floor_grid": list(SMCE_PATH_GRID), "launch_floor_block": list(SMCE_PATH_BLOCK),
           **_smce_bound(BATCH, 1000, torch.float32)}
    lm = {}
    n, d = GPT2_SMALL["batch"] * GPT2_SMALL["seq"], GPT2_VOCAB
    for dtype in (torch.float32, torch.bfloat16):
        x, labels = smce_inputs(n, d, dtype, seed=17, padding=False)
        library = _smce_library(x, labels)

        def kernel():
            return entry.kernel(x, labels)

        t = {"shape": [n, d], "dtype": str(dtype), "ms": cuda_ms(kernel, iters=20, warmup=3),
             **kernel_device_ms(kernel, "smce_kernel", iters=10),
             "library_ms": cuda_ms(library, iters=20, warmup=3),
             "library_device_ms": library_device_ms(library, iters=10),
             **_smce_bound(n, d, dtype)}
        t["bound_share_device"] = t["bound_ms"] / t["kernel_device_ms"] \
            if t["kernel_device_ms"] else None
        lm[str(dtype).removeprefix("torch.")] = t
        del x, labels, library
    out["lm_head"] = lm
    return out


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _grads(fn, inputs, ct):
    """Gradients of ``fn(*inputs)`` under the cotangent ``ct``, taken with
    respect to fresh copies of ``inputs``."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    fn(*leaves).backward(ct)
    return [t.grad for t in leaves]


def check_layernorm(entry, LayerNormFn):
    """Kernel vs plain: y, mean, rstd and dx, dgamma, dbeta; returns the
    largest absolute error at the transformer path's shape (8192, 768) f32."""
    f32 = torch.float32
    cases = [(8192, 768, f32, 0.0), (13, 33, f32, 0.0), (4096, 1024, torch.bfloat16, 100.0)]
    main_err = None
    for i, (n, d, dtype, mu) in enumerate(cases):
        rtol, atol = entry.tolerance(dtype)
        srtol, satol = entry.tolerance(f32)   # mean, rstd and dgamma, dbeta are f32
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        x = (torch.randn(n, d, generator=gen, device="cuda") * 3 + mu).to(dtype)
        gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
        ct = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
        before = entry.launches
        yk, mk, rk = entry.kernel(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        if entry.launches != before + 1:
            raise RuntimeError("layernorm wrapper did not launch its kernel")
        yp, mp, rp = entry.plain(x, gamma, beta, 1e-5)
        torch.testing.assert_close(yk.float(), yp.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(mk, mp, rtol=srtol, atol=satol)
        torch.testing.assert_close(rk, rp, rtol=srtol, atol=satol)
        dxk, dgk, dbk = _grads(lambda *a: LayerNormFn.apply(*a, 1e-5), (x, gamma, beta), ct)
        dxp, dgp, dbp = _grads(lambda *a: entry.plain(*a, 1e-5)[0], (x, gamma, beta), ct)
        torch.testing.assert_close(dxk.float(), dxp.float(), rtol=rtol, atol=atol)
        for gk, gp in ((dgk, dgp), (dbk, dbp)):   # sums over n rows
            torch.testing.assert_close(gk, gp, rtol=srtol,
                                       atol=satol * max(1.0, gp.abs().max().item()))
        torch.cuda.synchronize()
        errs = {"y": _max_err(yk, yp), "mean": _max_err(mk, mp), "rstd": _max_err(rk, rp),
                "dx": _max_err(dxk, dxp), "dgamma": _max_err(dgk, dgp),
                "dbeta": _max_err(dbk, dbp)}
        emit("kernel_check", kernel=entry.name, shape=[n, d], dtype=str(dtype), row_mean=mu,
             rtol=rtol, atol=atol, stats_rtol=srtol, stats_atol=satol, max_abs_err=errs)
        if (n, d, dtype) == (8192, 768, f32):
            main_err = max(errs.values())
    return main_err


def attention_inputs(shape, dtype, layout, gen):
    """q, k, v and a cotangent of ``shape`` (B, H, S, D) on the card.
    ``contiguous``; ``head_split``, views of (B, S, H * D) as the block makes
    them; ``unaligned``, views sliced from a wider buffer at an offset of one
    element, whose rows start off 16-byte boundaries; ``ring_chunk``, one
    chunk of a sequence cut for the sp = 8 ring; ``generation_prefill``,
    a prefill cohort of ``GEN``'s model (``generation_prefill_qkv``)."""
    b, h, s, d = shape

    def one():
        if layout == "head_split":
            return (torch.randn(b, s, h * d, generator=gen, device="cuda").to(dtype)
                    .reshape(b, s, h, d).transpose(1, 2))
        if layout == "unaligned":
            wide = torch.randn(b, h, s, d + 3, generator=gen, device="cuda").to(dtype)
            view = wide[..., 1:d + 1]
            if view.data_ptr() % 16 == 0 or (view.stride(2) * view.element_size()) % 16 == 0:
                raise RuntimeError("the unaligned case is aligned")
            return view
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ct = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if layout == "ring_chunk":   # one of the sp = 8 ring's chunks of a sequence
        return (*(torch.randn(b, h, s * MESH["ring_sp"], d, generator=gen, device="cuda")
                  .to(dtype).chunk(MESH["ring_sp"], dim=2)[1] for _ in range(3)), ct)
    if layout == "generation_prefill":
        return (*generation_prefill_qkv(gen), ct)
    return one(), one(), one(), ct


# (shape, causal, dtype, layout)
ATTENTION_CASES = [
    ((8, 12, 1024, 64), True, torch.float32, "contiguous"),
    ((2, 2, 100, 32), True, torch.float32, "contiguous"),
    ((1, 2, 64, 32), False, torch.float32, "contiguous"),
    ((2, 4, 256, 128), True, torch.bfloat16, "contiguous"),
    # the path's shape and layout
    ((8, 12, 1024, 64), True, torch.float32, "head_split"),
    ((8, 12, 1024, 64), True, torch.bfloat16, "head_split"),
    # ragged S and a head dim that is not a power of two
    ((1, 3, 333, 80), True, torch.float32, "contiguous"),
    ((2, 2, 256, 128), False, torch.float32, "contiguous"),
    # rows off 16-byte boundaries: the scalar staging path, at each padded
    # width (kD 32, 64, 128) in both types
    ((2, 3, 197, 40), True, torch.bfloat16, "unaligned"),
    ((1, 2, 96, 24), False, torch.bfloat16, "unaligned"),
    ((1, 2, 160, 128), True, torch.bfloat16, "unaligned"),
    ((2, 2, 77, 20), False, torch.float32, "unaligned"),
    ((1, 3, 150, 63), True, torch.float32, "unaligned"),
    ((1, 2, 130, 100), True, torch.float32, "unaligned"),
    # the sp = 8 ring's chunks of (8, 12, 1024, 64): the diagonal step and a
    # full one (slice_mesh)
    ((8, 12, 128, 64), True, torch.float32, "ring_chunk"),
    ((8, 12, 128, 64), False, torch.float32, "ring_chunk"),
    # the generation prefill's cohort: tiny_lm's q, k, v at (4, 1, 1024, 128),
    # two right-padded prompts and two padding rows
    ((4, 1, 1024, 128), True, torch.float32, "generation_prefill"),
]
def check_attention(entry, FlashAttention):
    """Kernel vs plain: o, m, l and dq, dk, dv; returns the largest absolute
    error at the transformer path's shape (8, 12, 1024, 64) f32 causal, in
    both layouts, and at the generation prefill's (4, 1, 1024, 128).  bf16 o
    is also held to ``ATTENTION_HALF_ROW_ULPS``."""
    from mxnet_tpu_torch.kernels.library import ATTENTION_HALF_ROW_ULPS, row_ulps

    f32 = torch.float32
    main_err = gen_err = 0.0
    for i, (shape, causal, dtype, layout) in enumerate(ATTENTION_CASES):
        rtol, atol = entry.tolerance(dtype)
        srtol, satol = entry.tolerance(f32)   # m and l are f32
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        q, k, v, ct = attention_inputs(shape, dtype, layout, gen)
        before = entry.launches
        ok, mk, lk = entry.kernel(q, k, v, causal)
        torch.cuda.synchronize()
        if entry.launches != before + 1:
            raise RuntimeError("attention wrapper did not launch its kernel")
        op, mp, lp = entry.plain(q, k, v, causal)
        torch.testing.assert_close(ok.float(), op.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(mk, mp, rtol=srtol, atol=satol)
        torch.testing.assert_close(lk, lp, rtol=srtol, atol=satol)
        extra = {}
        if dtype == torch.bfloat16:
            extra = {"o_row_ulps": row_ulps(ok, op),
                     "o_row_ulps_max": ATTENTION_HALF_ROW_ULPS}
            if extra["o_row_ulps"] > ATTENTION_HALF_ROW_ULPS:
                raise RuntimeError(f"bf16 o is {extra['o_row_ulps']:.2f} ulps of its row's "
                                   f"scale off the plain version at {shape}")
        grads_k = _grads(lambda *a: FlashAttention.apply(*a, causal, None), (q, k, v), ct)
        grads_p = _grads(lambda *a: entry.plain(*a, causal)[0], (q, k, v), ct)
        for gk, gp in zip(grads_k, grads_p):
            torch.testing.assert_close(gk.float(), gp.float(), rtol=rtol, atol=atol)
        torch.cuda.synchronize()
        errs = {"o": _max_err(ok, op), "m": _max_err(mk, mp), "l": _max_err(lk, lp),
                **{f"d{n}": _max_err(gk, gp) for n, gk, gp in zip("qkv", grads_k, grads_p)}}
        emit("kernel_check", kernel=entry.name, shape=list(shape), causal=causal,
             dtype=str(dtype), layout=layout, q_strides=list(q.stride()), rtol=rtol,
             atol=atol, stats_rtol=srtol, stats_atol=satol, max_abs_err=errs, **extra)
        if (shape, dtype) == ((8, 12, 1024, 64), f32):
            main_err = max(main_err, *errs.values())
        if layout == "generation_prefill":
            gen_err = max(errs.values())
        del q, k, v, ct, grads_k, grads_p
    return main_err, gen_err


def _stack_forward(tp, pipeline, stacked, x, heads):
    return pipeline.pipeline_apply(
        lambda p, t: tp.transformer_block_ref(p, t, heads, causal=True), stacked, x)


def run_transformer_slice(library, tp, pipeline):
    """One forward of the full-width stack, launch counts reset just before."""
    c = GPT2_SMALL
    gen = torch.Generator(device="cuda").manual_seed(0)
    stacked = pipeline.stack_stage_params(
        [tp.init_transformer_params(c["embed"], c["ffn"], c["heads"], generator=gen)
         for _ in range(c["layers"])])
    x = torch.randn(c["batch"], c["seq"], c["embed"], generator=gen, device="cuda")

    def forward():
        with torch.no_grad():
            return _stack_forward(tp, pipeline, stacked, x, c["heads"])

    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"stack output {tuple(out.shape)} is not finite or not {tuple(x.shape)}")
    want = {"layernorm": 2 * c["layers"], "attention": c["layers"]}
    for name, count in want.items():
        if launches[name] != count:
            raise RuntimeError(f"{name} launched {launches[name]} times in one forward of "
                               f"{c['layers']} layers, expected {count}")
    n_params = sum(t.numel() for t in stacked.values())
    emit("slice_transformer", model="gpt2_small_block_stack", **c, causal=True,
         dtype="float32", params=n_params, launches=launches, seconds=seconds,
         out_abs_mean=out.abs().mean().item(), out_std=out.std().item())
    return forward, launches


def run_transformer_parity(tp, pipeline):
    """A narrow stack's forward and the gradients of out.sum() on the card
    (kernels) and on the CPU (plain versions), from the same weights."""
    c = NARROW_TF
    gen = torch.Generator().manual_seed(5)
    stages = []
    for _ in range(c["layers"]):
        p = tp.init_transformer_params(c["embed"], c["ffn"], c["heads"], generator=gen,
                                       device="cpu")
        for name in ("bq", "bk", "bv", "bo", "b1", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            p[name] = p[name] + 0.1 * torch.randn(p[name].shape, generator=gen)
        stages.append(p)
    stacked = pipeline.stack_stage_params(stages)
    x = torch.randn(c["batch"], c["seq"], c["embed"], generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        params = {k: v.to(device).requires_grad_(True) for k, v in stacked.items()}
        xd = x.to(device).requires_grad_(True)
        out = _stack_forward(tp, pipeline, params, xd, c["heads"])
        out.sum().backward()
        results[device] = {"out": out.detach(), "grad:x": xd.grad,
                           **{f"grad:{k}": v.grad for k, v in params.items()}}
    worst = 0.0
    for key, want in results["cpu"].items():
        got = results["cuda"][key].cpu()
        torch.testing.assert_close(got, want, rtol=PARITY_TF_TOL,
                                   atol=PARITY_TF_TOL * max(1.0, want.abs().max().item()),
                                   msg=lambda m, key=key: f"{key}: {m}")
        worst = max(worst, (got - want).abs().max().item())
    emit("parity_transformer", **c, causal=True, tensors=len(results["cpu"]),
         rtol=PARITY_TF_TOL, atol_per_unit_max=PARITY_TF_TOL, max_abs_err=worst)


def _mesh_close(name, got, want):
    """The largest |got - want|, after holding it to ``MESH_TOL``."""
    torch.testing.assert_close(got, want, rtol=MESH_TOL,
                               atol=MESH_TOL * max(1.0, want.abs().max().item()),
                               msg=lambda m: f"{name}: {m}")
    return (got - want).abs().max().item()


def _update_close(name, new, new_ref, old, scale=None):
    """Hold one SGD update, ``new - old``, to the oracle's: within
    ``MESH_TOL`` of ``scale`` (the oracle update's own largest magnitude
    unless given, and then it must be non-zero), plus two
    roundings to f32 at the parameter's magnitude (each side stores
    ``old - lr * g`` once, and the subtraction that recovers the update
    may round once more).  A missing update fails at its largest element
    wherever that bound is below the update's scale; the record keeps both.
    Returns the largest |error|, the update's scale and the largest bound
    an element got."""
    got, want = new - old, new_ref - old
    if scale is None:
        scale = want.abs().max().item()
        if scale == 0.0:
            raise RuntimeError(f"{name}: the oracle's step did not move it")
    rounding = 2 * torch.finfo(old.dtype).eps * torch.maximum(old.abs(), new_ref.abs())
    bound = MESH_TOL * scale + rounding
    err = (got - want).abs()
    if not bool((err <= bound).all()):
        worst = int(torch.argmax(err - bound))
        raise AssertionError(f"{name}: |update - oracle's| {err.flatten()[worst].item()} over "
                             f"its bound {bound.flatten()[worst].item()} (update scale {scale})")
    return {"max_abs_err": err.max().item(), "scale": scale, "max_bound": bound.max().item()}


def ring_in_process(ring, q, k, v, sp, causal):
    """The sp-way ring's local steps in one process: for each virtual rank,
    ``ring._fold`` (the code each rank runs) over the k/v chunks in ring
    order; the ranks' outputs concatenated over the sequence."""
    scale = q.shape[-1] ** -0.5
    qs, ks, vs = (t.chunk(sp, dim=2) for t in (q, k, v))
    outs = []
    for idx in range(sp):
        carry = ring._empty_partial(qs[idx])
        for i in range(sp):
            src = (idx - i) % sp
            carry = ring._fold(carry, qs[idx], ks[src], vs[src], src, idx, causal, scale)
        outs.append(carry[0])
    return torch.cat(outs, dim=2)


def run_slice_mesh(library, parallel):
    """The mesh path on a one-device mesh (every axis of size 1, no process
    group) at GPT-2 small's block widths, attention launches reset just
    before and read just after.  Each sub-phase is timed by CUDA events and
    held to its single-device version."""
    from mxnet_tpu_torch.ops.attention import reference_attention
    from mxnet_tpu_torch.parallel import composed, ring

    c, m = GPT2_SMALL, MESH
    b, s, e, h, f = c["batch"], c["seq"], c["embed"], c["heads"], c["ffn"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    mesh = parallel.make_mesh(dp=1, tp=1, sp=1, pp=1, ep=1)
    params = parallel.init_transformer_params(e, f, h, generator=gen)
    for name in ("bq", "bk", "bv", "bo", "b1", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b"):
        params[name] = params[name] + 0.1 * torch.randn(params[name].shape, generator=gen,
                                                        device="cuda")
    x = torch.randn(b, s, e, generator=gen, device="cuda")
    phases, errs, warm = [], {}, {}

    def phase(name, fn, want_attention):
        torch.cuda.synchronize()
        before = {k: kk.launches for k, kk in library.KERNELS.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        launches = {k: kk.launches - before[k] for k, kk in library.KERNELS.items()}
        if launches["attention"] != want_attention:
            raise RuntimeError(f"slice_mesh {name}: attention launched "
                               f"{launches['attention']} times, expected {want_attention}")
        phases.append({"name": name, "first_call_ms": start.elapsed_time(end),
                       "launches": launches})
        warm[name] = (fn, torch.is_grad_enabled())
        return out

    torch.cuda.synchronize()
    library.reset_launches()

    # the TP block at tp = 1 and the single-device block: one code path
    with torch.no_grad():
        got = phase("transformer_block_tp", lambda: parallel.transformer_block_tp(
            mesh, parallel.shard_transformer_params(mesh, params), x, h, causal=True), 1)
        want = phase("transformer_block_ref",
                     lambda: parallel.transformer_block_ref(params, x, h, causal=True), 1)
    if not torch.equal(got, want):
        raise RuntimeError("transformer_block_tp at tp=1 is not bit-equal to "
                           f"transformer_block_ref: {(got - want).abs().max().item()}")
    errs["transformer_block_tp"] = 0.0

    # ring attention on the one-device mesh, and the sp = 8 ring in one process
    q, k, v, ct = (torch.randn(b, h, s, e // h, generator=gen, device="cuda") for _ in range(4))
    with torch.no_grad():
        o = phase("ring_self_attention", lambda: parallel.ring_self_attention(
            mesh, q, k, v, causal=True), 1)
        o_ref = reference_attention(q, k, v, True)
    errs["ring_self_attention"] = _mesh_close("ring_self_attention", o, o_ref)
    sp = m["ring_sp"]
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def ring_fwd_bwd():
        out = ring_in_process(ring, qg, kg, vg, sp, True)
        return (out.detach(), *torch.autograd.grad(out, (qg, kg, vg), ct))

    got = phase(f"ring_sp{sp}_in_process", ring_fwd_bwd, sp + sp * (sp - 1) // 2)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = reference_attention(qr, kr, vr, True)
    want = (ref.detach(), *torch.autograd.grad(ref, (qr, kr, vr), ct))
    for name, g_, w_ in zip(("o", "dq", "dk", "dv"), got, want):
        errs[f"ring_sp{sp}_{name}"] = _mesh_close(f"ring sp={sp} {name}", g_, w_)
    del qr, kr, vr, got, want, ref

    # GPipe, M microbatches over one stage of the block
    def stage(p, t):
        return parallel.transformer_block_ref(p, t, h, causal=True)

    stacked = parallel.stack_stage_params([params])
    with torch.no_grad():
        y = phase("gpipe_fn", lambda: parallel.gpipe_fn(stage, mesh, m["microbatches"])(
            stacked, x), m["microbatches"])
        y_ref = parallel.pipeline_apply(stage, stacked, x)
    errs["gpipe_fn"] = _mesh_close("gpipe_fn", y, y_ref)

    # expert-parallel MoE against the dense layer
    moe = parallel.init_moe_params(e, f, m["moe_experts"], generator=gen)
    tokens = x.reshape(-1, e)[:m["moe_tokens"]]
    with torch.no_grad():
        y_ep, aux_ep = phase("moe_ffn_ep", lambda: parallel.moe_ffn_ep(
            moe, tokens, mesh, capacity_factor=m["moe_capacity_factor"]), 0)
        y_dense, aux_dense = parallel.moe_ffn(moe, tokens, m["moe_capacity_factor"])
    errs["moe_ffn_ep"] = _mesh_close("moe_ffn_ep", y_ep, y_dense)
    errs["moe_ffn_ep_aux"] = _mesh_close("moe_ffn_ep aux", aux_ep, aux_dense)
    dropped = int((y_dense.abs().sum(dim=1) == 0).sum())

    # one composed dp x tp x pp train step against its oracle
    step, oracle = parallel.pp_tp_train_step(mesh, h, m["microbatches"], lr=m["lr"])
    target = torch.randn(b, s, e, generator=gen, device="cuda")
    new, loss = phase("pp_tp_train_step", lambda: step(stacked, x, target), m["microbatches"])
    new_ref, loss_ref = oracle(stacked, x, target)
    errs["pp_tp_train_step_loss"] = _mesh_close("pp_tp loss", loss, loss_ref)
    updates = {name: _update_close(f"pp_tp update {name}", new[name], new_ref[name],
                                   stacked[name]) for name in new if name != "bk"}
    # bk's gradient is zero in exact arithmetic (a row's scores all shift by
    # q . bk, which softmax ignores): its update is rounding noise, held to
    # the step's largest update instead of its own
    updates["bk"] = _update_close("pp_tp update bk", new["bk"], new_ref["bk"], stacked["bk"],
                                  scale=max(u["scale"] for u in updates.values()))
    for name, u in updates.items():
        errs[f"pp_tp_train_step_update:{name}"] = u["max_abs_err"]

    torch.cuda.synchronize()
    launches = {name: kk.launches for name, kk in library.KERNELS.items()}
    if launches["attention"] == 0:
        raise RuntimeError("slice_mesh launched no attention kernel")
    for row in phases:
        emit("slice_mesh_phase", **row)
    emit("slice_mesh", model="gpt2_small_block", embed=e, heads=h, ffn=f, batch=b, seq=s,
         causal=True, dtype="float32", mesh=mesh.axes, **m, moe_tokens_dropped=dropped,
         loss=loss.item(), tol=MESH_TOL, max_abs_err=errs, pp_tp_updates=updates,
         launches=launches,
         attention_launches=launches["attention"])
    print(f"slice_mesh attention launches: {launches['attention']}", flush=True)
    return launches, max(errs.values()), warm


def time_mesh_phases(fns):
    """Each slice_mesh sub-phase again, warm: mean CUDA-event ms of 3 calls
    after one (its first call in the path pays cuBLAS's and the allocator's
    first use)."""
    out = {}
    for name, (fn, grad) in fns.items():
        with torch.set_grad_enabled(grad):
            out[name] = cuda_ms(fn, iters=3, warmup=1)
    return out


def ring_chunk_inputs(causal):
    """q, k, v of the sp = 8 ring's chunks: (8, 12, 128, 64) views of
    (8, 12, 1024, 64), as ``ring_in_process`` hands them to the kernel."""
    c = GPT2_SMALL
    gen = torch.Generator(device="cuda").manual_seed(13 + int(causal))
    full = [torch.randn(c["batch"], c["heads"], c["seq"], c["embed"] // c["heads"],
                        generator=gen, device="cuda") for _ in range(3)]
    return [t.chunk(MESH["ring_sp"], dim=2)[1] for t in full]


def time_ring_chunk_events(entry):
    """Events ms of the kernel, its plain version and SDPA at the ring's
    chunk, causal (the diagonal step) and full, before any profiler
    session."""
    import torch.nn.functional as F

    out = {}
    for causal in (True, False):
        q, k, v = ring_chunk_inputs(causal)
        out["causal" if causal else "full"] = {
            "shape": list(q.shape), "causal": causal, "dtype": "float32",
            "ms": cuda_ms(lambda: entry.kernel(q, k, v, causal), iters=100, warmup=5),
            "plain_ms": cuda_ms(lambda: entry.plain(q, k, v, causal), iters=20, warmup=2),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), iters=100, warmup=5),
            "library": f"F.scaled_dot_product_attention(is_causal={causal}), o only"}
    return out


def time_ring_chunk(entry, events):
    """``events`` with the profiler's device times and the bound: q, k, v in
    and o, m, l out once; 4 D operations a kept (q, k) pair at the 3xTF32
    rate, as ``time_attention`` counts them."""
    import torch.nn.functional as F

    for key, t in events.items():
        causal = t["causal"]
        q, k, v = ring_chunk_inputs(causal)
        b, h, s, d = q.shape
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 4 * d * b * h * pairs
        nbytes = 4 * q.numel() * 4 + 2 * b * h * s * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * ops / TF32_OPS_PER_S * 1e3
        t.update(kernel_device_ms(lambda: entry.kernel(q, k, v, causal), "flash_attn_mma_kernel"),
                 library_device_ms=library_device_ms(
                     lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)),
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
                 operations=ops, tensor_core_operations=3 * ops)
    return events


def time_layernorm(entry, host):
    """``host`` (``host_bound_times``) with the device times at the path's
    shape and the bound."""
    x, gamma, beta = ln_path_inputs()
    n, d = x.shape
    # each input read once, each output written once: x, gamma, beta in;
    # y, mean, rstd out
    nbytes = 2 * x.numel() * x.element_size() + 2 * d * 4 + 2 * n * 4
    # per element: sum; sub, mul-add (squares); sub, mul, mul, add
    ops = 7 * n * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"shape": [n, d], "dtype": "float32", **host, "library": "torch.native_layer_norm",
            **kernel_device_ms(lambda: entry.kernel(x, gamma, beta), "ln_fwd_kernel"),
            "library_device_ms": library_device_ms(_ln_library(x, gamma, beta)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


def time_attention(entry):
    """Kernel, plain and library times at the path's shape and layout (q, k
    and v as head-split views of (batch, seq, embed)), f32 and bf16, and the
    bounds.  ``bound_ms`` is the least time for the work at the rate of the
    arithmetic the kernel runs: three TF32 products for f32 (the tensor
    cores' way to f32 accuracy), bf16 tensor cores for bf16.  For f32,
    ``bound_cuda_cores_ms`` is the bound of strict f32 on the CUDA cores."""
    import torch.nn.functional as F

    c = GPT2_SMALL
    b, s, h, e = c["batch"], c["seq"], c["heads"], c["embed"]
    dh = e // h
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(b, s, e, generator=gen, device="cuda")
               .reshape(b, s, h, dh).transpose(1, 2) for _ in range(3))
    # the pairs the causal mask keeps, S(S+1)/2 per head: 2*dh for q.k and
    # 2*dh for p*v each
    ops = 4 * dh * b * h * s * (s + 1) // 2

    def timed(q, k, v, ops_per_s, tc_ops):
        def kernel():
            return entry.kernel(q, k, v, True)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        # q, k, v in; o, m, l out
        nbytes = 4 * q.numel() * q.element_size() + 2 * b * h * s * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = tc_ops / ops_per_s * 1e3
        return {"shape": [b, h, s, dh], "causal": True, "dtype": str(q.dtype),
                "ms": cuda_ms(kernel, iters=50, warmup=5),
                **kernel_device_ms(kernel, "flash_attn_mma_kernel", iters=20),
                # o only: SDPA returns no running max or sum
                "library_ms": cuda_ms(sdpa, iters=50, warmup=5),
                "library_device_ms": library_device_ms(sdpa, iters=20),
                "library": "F.scaled_dot_product_attention(is_causal=True), o only",
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": ops, "tensor_core_operations": tc_ops,
                "tensor_core_ops_per_s": ops_per_s}

    f32 = timed(q, k, v, TF32_OPS_PER_S, 3 * ops)
    f32["bound_cuda_cores_ms"] = max(f32["bytes"] / HBM_BYTES_PER_S,
                                     ops / FP32_OPS_PER_S) * 1e3
    f32["plain_ms"] = cuda_ms(lambda: entry.plain(q, k, v, True), iters=10, warmup=2)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))   # the same head-split strides
    f32["bf16"] = timed(qb, kb, vb, BF16_OPS_PER_S, ops)
    return f32


def _raises(fn, match):
    """The MXNetError message of fn(); fails unless it raises one holding ``match``."""
    from mxnet_tpu_torch.base import MXNetError

    try:
        fn()
    except MXNetError as e:
        if match not in str(e):
            raise RuntimeError(f"error without {match!r}: {e}") from e
        return str(e).splitlines()[0][:200]
    raise RuntimeError(f"expected MXNetError holding {match!r}; nothing was raised")


def run_rtc_semantics(mx, nd, rtc):
    """The cases of tests/test_rtc.py in CUDA C through mx.rtc, each result
    exact; a compile error and a 2048-thread launch must raise."""
    gpu = mx.gpu(0)
    seconds, cases = {}, {}

    def module(name, src, **kw):
        mod = rtc.CudaModule(src, **kw)
        seconds[name] = mod.compile_seconds
        return mod

    def exact(case, got, want):
        np.testing.assert_array_equal(got.asnumpy(), want, err_msg=case)
        cases[case] = "ok"

    axpy = module("axpy", AXPY_SRC).get_kernel("axpy", AXPY_SIG)
    x, y = nd.ones((10,), ctx=gpu), nd.zeros((10,), ctx=gpu)
    axpy.launch([x, y, 3.0], gpu, (1, 1, 1), (10, 1, 1))
    exact("axpy_first", y, np.full(10, 3.0, np.float32))
    axpy.launch([x, y, 3.0], gpu, (1, 1, 1), (10, 1, 1))
    exact("axpy_second", y, np.full(10, 6.0, np.float32))
    if (y.version, x.version) != (2, 0):
        raise RuntimeError(f"versions after two launches: y {y.version}, x {x.version}")

    k = module("scale2", RTC_CASES_SRC["scale2"]).get_kernel(
        "scale2", "const float *x, float *a, float *b")
    xn = np.arange(6, dtype=np.float32).reshape(2, 3)
    a, b = nd.zeros((2, 3), ctx=gpu), nd.zeros((2, 3), ctx=gpu)
    k.launch([nd.array(xn, ctx=gpu), a, b], gpu, (1, 1, 1), (6, 1, 1))
    exact("two_outputs_a", a, xn * 2)
    exact("two_outputs_b", b, xn * 3)

    k = module("rowscale", RTC_CASES_SRC["rowscale"]).get_kernel(
        "rowscale", "const float *x, float *y, float alpha, int cols")
    xn = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = nd.zeros((8, 4), ctx=gpu)
    k.launch([nd.array(xn, ctx=gpu), y, 0.5, 4], gpu, (8, 1, 1), (4, 1, 1))
    exact("rows_by_blockIdx", y, xn * np.float32(0.5))

    k = module("addi", RTC_CASES_SRC["addi"]).get_kernel(
        "addi", "const int32 *x, int32 *y, int32 k")
    y = nd.zeros((5,), ctx=gpu, dtype="int32")
    k.launch([nd.array(np.arange(5, dtype=np.int32), ctx=gpu), y, 7], gpu, (1,), (5,))
    exact("int32", y, np.arange(5, dtype=np.int32) + 7)

    mod = module("scale_t", RTC_CASES_SRC["scale_t"],
                 exports=["scale_t<float>", "scale_t<double>"])
    k = mod.get_kernel("scale_t<double>", "const double *x, double *y, double alpha, int n")
    xn = np.linspace(-1, 1, 300)
    y = nd.zeros((300,), ctx=gpu, dtype="float64")
    k.launch([nd.array(xn, ctx=gpu, dtype="float64"), y, 0.25, 300], gpu, (3,), (128,))
    exact("template_through_exports", y, xn * 0.25)
    cases["unexported_name"] = _raises(lambda: mod.get_kernel("scale_t", "int n"), "exports")

    n = 100 * 1024 // 4
    k = module("smem_reverse", RTC_CASES_SRC["smem_reverse"]).get_kernel(
        "smem_reverse", "const float *x, float *y, int n")
    xn = np.arange(n, dtype=np.float32)
    y = nd.zeros((n,), ctx=gpu)
    k.launch([nd.array(xn, ctx=gpu), y, n], gpu, (1,), (256,), shared_mem=n * 4)
    exact("dynamic_shared_100KiB", y, xn[::-1])

    k = module("scalars", RTC_CASES_SRC["scalars"]).get_kernel(
        "scalars", "float *out, half h, bfloat16 b, double d, int8 i8, uint8 u8")
    out = nd.zeros((5,), ctx=gpu)
    k.launch([out, 0.1, 0.1, -2.5, -3, 250], gpu, (1,), (1,))
    bf16_bits = torch.tensor(0.1, dtype=torch.bfloat16).view(torch.int16).item()
    exact("scalar_packing", out, np.array([np.float16(0.1).view(np.uint16), bf16_bits,
                                           -2.5, -3, 250], np.float32))

    t0 = time.perf_counter()
    cases["compile_error"] = _raises(
        lambda: rtc.CudaModule('extern "C" __global__ void broken(float *x) '
                               '{ x[0] = undefined_name; }'), "undefined_name")
    seconds["compile_error"] = time.perf_counter() - t0
    big = [nd.ones((2048,), ctx=gpu), nd.zeros((2048,), ctx=gpu), 1.0]
    cases["block_of_2048_threads"] = _raises(
        lambda: axpy.launch(big, gpu, (1, 1, 1), (2048, 1, 1)), "cuLaunchKernel")
    if big[1].version != 0 or big[1].asnumpy().any():
        raise RuntimeError("the refused 2048-thread launch wrote its output")
    cases["unknown_kernel"] = _raises(lambda: rtc.CudaModule(AXPY_SRC).get_kernel(
        "nope", "const float *x"), "no kernel 'nope'")
    cases["cpu_context"] = _raises(
        lambda: axpy.launch([x, y, 1.0], mx.cpu(), (1,), (10,)), "no CPU path")
    torch.cuda.synchronize()
    emit("rtc", nvrtc=rtc.nvrtc_version(), arch=rtc.ARCH, compile_seconds=seconds,
         cases=cases, launches_total=rtc.launches)


def _axpy_dims(n):
    """(grid, block) for the doc axpy over ``n`` elements: a block size that
    divides ``n`` (the kernel has no bounds check) and leaves the fewest
    idle lanes in its last warp, the larger on a tie."""
    divisors = [d for d in range(32, 1025) if n % d == 0]
    if not divisors:
        raise RuntimeError(f"{n} has no divisor in [32, 1024] for the doc axpy")
    block = max(divisors, key=lambda d: (d / (32 * math.ceil(d / 32)), d))
    return n // block, block


def _sgd_mom_dims(n):
    return min(math.ceil(n / SGD_MOM_THREADS), SGD_MOM_MAX_BLOCKS), SGD_MOM_THREADS


def run_rtc_full_width(mx, nd, rtc, library, vision, Xavier, sgd_mom_update):
    """The slice at full width: ResNet-50 v1's trainable tensors as
    NDArrays (no copy), the sgd_mom kernel once per tensor, the doc axpy
    over 25 575 912 floats, and the .params round trip of the whole net."""
    gpu = mx.gpu(0)
    net = resnet50(vision, Xavier, 0)
    net.to("cuda")
    weights = [p._tensor().detach() for p in net.collect_params().values()
               if p._tensor().requires_grad]
    n_params = sum(w.numel() for w in weights)
    if n_params != RESNET50_TRAINABLE:
        raise RuntimeError(f"resnet50_v1 has {n_params} trainable parameters")
    gen = torch.Generator(device="cuda").manual_seed(11)
    grads = [torch.randn(w.shape, generator=gen, device="cuda") for w in weights]
    moms = [0.01 * torch.randn(w.shape, generator=gen, device="cuda") for w in weights]
    ref = [(w.clone(), g.clone(), m.clone()) for w, g, m in zip(weights, grads, moms)]
    W, G, M = ([nd.from_dlpack(t) for t in ts] for ts in (weights, grads, moms))
    for arr, t in zip(W + G + M, weights + grads + moms):
        if torch.from_dlpack(nd.to_dlpack_for_read(arr)).data_ptr() != t.data_ptr():
            raise RuntimeError("nd.from_dlpack copied a tensor")
    sgd = rtc.CudaModule(SGD_MOM_SRC)
    sgd_k = sgd.get_kernel("sgd_mom", SGD_MOM_SIG)
    axpy_mod = rtc.CudaModule(AXPY_SRC)
    axpy_k = axpy_mod.get_kernel("axpy", AXPY_SIG)
    x = torch.randn(RESNET50_TRAINABLE, generator=gen, device="cuda")
    y = torch.randn(RESNET50_TRAINABLE, generator=gen, device="cuda")
    y_ref, alpha = y.clone(), 0.5
    X, Y = nd.from_dlpack(x), nd.from_dlpack(y)
    grid, block = _axpy_dims(RESNET50_TRAINABLE)
    scalars = [SGD["lr"], SGD["momentum"], SGD["wd"], SGD["rescale_grad"]]

    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    for g, w, m in zip(G, W, M):
        blocks, threads = _sgd_mom_dims(w.size)
        sgd_k.launch([g, w, m, *scalars, w.size], gpu, (blocks, 1, 1), (threads, 1, 1))
    axpy_k.launch([X, Y, alpha], gpu, (grid, 1, 1), (block, 1, 1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"sgd_mom": sgd_k.launches, "axpy": axpy_k.launches, "rtc": rtc.launches,
                **{name: k.launches for name, k in library.KERNELS.items()}}
    if (launches["sgd_mom"], launches["axpy"], launches["rtc"]) != \
            (len(weights), 1, len(weights) + 1):
        raise RuntimeError(f"launches {launches} for {len(weights)} tensors")
    if any(a.version != 1 for a in W + M) or any(a.version != 0 for a in G):
        raise RuntimeError("outputs must be bumped once and inputs never")

    errs = {"weight": 0.0, "mom": 0.0}
    for (rw, rg, rm), w, m in zip(ref, weights, moms):
        sgd_mom_update(rw, rg, rm, lr=SGD["lr"], wd=SGD["wd"], momentum=SGD["momentum"],
                       rescale_grad=SGD["rescale_grad"])
        torch.testing.assert_close(w, rw, rtol=RTC_RTOL, atol=RTC_ATOL)
        torch.testing.assert_close(m, rm, rtol=RTC_RTOL, atol=RTC_ATOL)
        errs["weight"] = max(errs["weight"], _max_err(w, rw))
        errs["mom"] = max(errs["mom"], _max_err(m, rm))
    y_ref += alpha * x
    torch.testing.assert_close(y, y_ref, rtol=RTC_RTOL, atol=RTC_ATOL)
    errs["axpy"] = _max_err(y, y_ref)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                        "_build", "resnet50_v1.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t1 = time.perf_counter()
    net.save_parameters(path)
    save_s, file_bytes = time.perf_counter() - t1, os.path.getsize(path)
    other = resnet50(vision, Xavier, 1)
    other.to("cuda")
    t1 = time.perf_counter()
    other.load_parameters(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    os.remove(path)
    mine, theirs = net._collect_params_with_prefix(), other._collect_params_with_prefix()
    if list(mine) != list(theirs):
        raise RuntimeError("the two nets' structured names differ")
    unequal = [k for k in mine if not torch.equal(mine[k]._tensor(), theirs[k]._tensor())]
    if unequal:
        raise RuntimeError(f"{len(unequal)} tensors differ after the round trip: {unequal[:3]}")
    emit("rtc_full_width", model="resnet50_v1", trainable_params=n_params,
         trainable_tensors=len(weights), sgd=SGD, axpy_elements=RESNET50_TRAINABLE,
         axpy_grid=[grid, 1, 1], axpy_block=[block, 1, 1], launches=launches,
         seconds=seconds, rtol=RTC_RTOL, atol=RTC_ATOL, max_abs_err=errs,
         nvrtc_compile_seconds={"sgd_mom": sgd.compile_seconds,
                                "axpy": axpy_mod.compile_seconds},
         params_file_bytes=file_bytes, params_tensors=len(mine), save_seconds=save_s,
         load_seconds=load_s, round_trip="bit-equal")
    state = {"gpu": gpu, "sgd_k": sgd_k, "axpy_k": axpy_k, "G": G, "W": W, "M": M,
             "X": X, "Y": Y, "x": x, "y": y, "alpha": alpha, "grid": grid, "block": block,
             "scalars": scalars, "weights": weights, "grads": grads, "moms": moms}
    return state, launches, max(errs.values())


def _rtc_calls(st, sgd_mom_update):
    """The timed calls of ``timing_rtc``: the doc axpy, its plain version and
    library call, and the sgd_mom pass over ResNet-50 and its plain version."""
    gpu, axpy_k, X, Y, x, y = st["gpu"], st["axpy_k"], st["X"], st["Y"], st["x"], st["y"]
    alpha, grid, block = st["alpha"], st["grid"], st["block"]
    sgd_k, scalars = st["sgd_k"], st["scalars"]
    tensors = list(zip(st["G"], st["W"], st["M"]))

    def axpy():
        axpy_k.launch([X, Y, alpha], gpu, (grid, 1, 1), (block, 1, 1))

    def sgd_pass():
        for g, w, m in tensors:
            blocks, threads = _sgd_mom_dims(w.size)
            sgd_k.launch([g, w, m, *scalars, w.size], gpu, (blocks, 1, 1), (threads, 1, 1))

    def plain_pass():
        for w, g, m in zip(st["weights"], st["grads"], st["moms"]):
            sgd_mom_update(w, g, m, lr=SGD["lr"], wd=SGD["wd"], momentum=SGD["momentum"],
                           rescale_grad=SGD["rescale_grad"])

    return {"axpy": axpy, "plain_axpy": lambda: y.add_(alpha * x),
            "library_axpy": lambda: y.add_(x, alpha=alpha), "sgd_pass": sgd_pass,
            "plain_pass": plain_pass}


def _pass_host_us_per_launch(sgd_pass, launches, passes=20):
    """Host microseconds a launch of the pass: the wall time of ``passes``
    passes enqueued without a synchronize, over their launches."""
    t0 = time.perf_counter()
    for _ in range(passes):
        sgd_pass()
    us = (time.perf_counter() - t0) * 1e6 / (passes * launches)
    torch.cuda.synchronize()
    return us


def rtc_graph_replay(st, sgd_pass, sgd_mom_update, replays=10, back_to_back=20):
    """The sgd_mom pass captured once in a CUDA graph (after the warm-up of
    ``rtc_full_width``) and replayed.  Capturing must run nothing and count
    one launch per tensor; each of ``replays`` replays starts from restored
    weights and momenta, is timed alone by CUDA events and is held to one
    ``sgd_mom_update`` of every tensor at RTC_RTOL / RTC_ATOL.  Then
    ``back_to_back`` replays in one event pair.  The inputs are restored."""
    weights, moms, grads = st["weights"], st["moms"], st["grads"]
    saved = [(w.clone(), m.clone()) for w, m in zip(weights, moms)]
    want = [(w.clone(), g, m.clone()) for w, g, m in zip(weights, grads, moms)]
    for w, g, m in want:
        sgd_mom_update(w, g, m, lr=SGD["lr"], wd=SGD["wd"], momentum=SGD["momentum"],
                       rescale_grad=SGD["rescale_grad"])

    def restore():
        for (w, m), (sw, sm) in zip(zip(weights, moms), saved):
            w.copy_(sw)
            m.copy_(sm)

    torch.cuda.synchronize()
    before = st["sgd_k"].launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sgd_pass()
    torch.cuda.synchronize()
    captured = st["sgd_k"].launches - before
    if captured != len(weights):
        raise RuntimeError(f"the capture counted {captured} launches for {len(weights)} tensors")
    if not all(torch.equal(w, sw) and torch.equal(m, sm)
               for (w, m), (sw, sm) in zip(zip(weights, moms), saved)):
        raise RuntimeError("capturing the pass ran it")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times, err = [], 0.0
    for _ in range(replays):
        restore()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        for (rw, _g, rm), w, m in zip(want, weights, moms):
            torch.testing.assert_close(w, rw, rtol=RTC_RTOL, atol=RTC_ATOL)
            torch.testing.assert_close(m, rm, rtol=RTC_RTOL, atol=RTC_ATOL)
            err = max(err, _max_err(w, rw), _max_err(m, rm))
    start.record()
    for _ in range(back_to_back):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    pipelined = start.elapsed_time(end) / back_to_back
    restore()
    torch.cuda.synchronize()
    del graph
    return {"graph_replay_ms": sorted(times)[len(times) // 2], "graph_replay_all_ms": times,
            "graph_replay_back_to_back_ms": pipelined, "graph_replays_checked": replays,
            "graph_max_abs_err": err, "graph_captured_launches": captured}


def rtc_launch_breakdown(st, rtc, calls=500, repeats=5):
    """Where the host time of one ``sgd_mom`` launch goes, at the 1000-float
    dense bias (a launch the host bounds), each part timed alone: the median
    of ``repeats`` runs of ``calls`` calls without a synchronize (fewer than
    the launches a stream queues, so the device never holds the host back):
    the caller's argument list and
    grid, the whole ``launch``, ``launch`` with its C call replaced by a
    Python function that returns 0 (the Python part), the plan's packing
    alone, torch's raw-stream read, and the C call alone on packed slots
    (ctypes, the context check and ``cuLaunchKernel``)."""
    from ctypes import c_void_p

    from mxnet_tpu_torch.kernels.launch import _current_raw_stream

    gpu, k, scalars = st["gpu"], st["sgd_k"], st["scalars"]
    g, w, m = next((g, w, m) for g, w, m in zip(st["G"], st["W"], st["M"]) if w.size == 1000)
    blocks, threads = _sgd_mom_dims(w.size)
    args = [g, w, m, *scalars, w.size]
    grid, block = (blocks, 1, 1), (threads, 1, 1)
    ctx, fn, _smem = k._devices[0]

    def caller():
        b, t = _sgd_mom_dims(w.size)
        return [g, w, m, *scalars, w.size], (b, 1, 1), (t, 1, 1)

    def c_call():
        rtc._C_LAUNCH(ctx, fn, *grid, *block, 0, c_void_p(_current_raw_stream(0)), params)

    def us(fn):
        return sorted(host_us_per_call(fn, calls) for _ in range(repeats))[repeats // 2]

    out = {"tensor_elements": w.size, "caller_us": us(caller),
           "launch_us": us(lambda: k.launch(args, gpu, grid, block)),
           "pack_us": us(lambda: k._pack(args, 0)),
           "raw_stream_us": us(lambda: _current_raw_stream(0))}
    params = k._pack(args, 0)
    out["c_call_us"] = us(c_call)
    c_launch = rtc._C_LAUNCH
    rtc._C_LAUNCH = lambda *a: 0
    try:
        out["python_us"] = us(lambda: k.launch(args, gpu, grid, block))
    finally:
        rtc._C_LAUNCH = c_launch
    return out


def rtc_host_bound_times(st, sgd_mom_update, rtc):
    """CUDA-event times of the doc axpy, the sgd_mom pass and their plain
    versions and library call, the host time a launch of the pass, and the
    pass replayed from a CUDA graph.  Taken before any torch.profiler session
    of the process, as ``host_bound_times`` is for the row kernels: the pass
    is host-bound, and a profiler session slows the host for the rest of the
    process."""
    calls = _rtc_calls(st, sgd_mom_update)
    tensors = len(st["weights"])
    axpy_t = {"ms": cuda_ms(calls["axpy"], iters=200, warmup=10),
              "plain_ms": cuda_ms(calls["plain_axpy"], iters=200, warmup=10),
              "library_ms": cuda_ms(calls["library_axpy"], iters=200, warmup=10)}
    sgd_t = {"ms": cuda_ms(calls["sgd_pass"], iters=20, warmup=2),
             "host_us_per_launch_before_profiler":
                 _pass_host_us_per_launch(calls["sgd_pass"], tensors),
             "plain_ms": cuda_ms(calls["plain_pass"], iters=10, warmup=2),
             "launch_breakdown_us": rtc_launch_breakdown(st, rtc),
             **rtc_graph_replay(st, calls["sgd_pass"], sgd_mom_update)}
    return axpy_t, sgd_t


def time_rtc(st, sgd_mom_update, before, multi_sgd_mom_update, multi_ms):
    """``before`` (``rtc_host_bound_times``) with the device times and the
    bounds of the doc axpy at 25 575 912 f32 and the sgd_mom pass over
    ResNet-50, and the pass's host readings once more after the profiler
    sessions.  The pass's library call is
    ``multi_sgd_mom_update`` over the same tensors (``torch._foreach_*``):
    ``multi_ms`` is its events time from ``multi_tensor_update``, and its
    device time is read here."""
    calls = _rtc_calls(st, sgd_mom_update)
    axpy_before, sgd_before = before
    n = st["x"].numel()
    # x read, y read and written; one multiply-add an element
    nbytes, ops = 3 * n * 4, 2 * n
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    axpy_t = {"shape": [n], "dtype": "float32", "grid": [st["grid"], 1, 1],
              "block": [st["block"], 1, 1], **axpy_before, "plain": "y += alpha * x",
              "library": "y.add_(x, alpha=alpha)",
              **kernel_device_ms(calls["axpy"], "axpy"),
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "bytes": nbytes, "operations": ops}
    tensors = len(st["weights"])
    total = sum(w.numel() for w in st["weights"])
    # grad read; weight and mom read and written; 7 operations an element
    nbytes, ops = 5 * total * 4, 7 * total
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    sgd_t = {"tensors": tensors, "elements": total, **sgd_before,
             "ms_after_profiler": cuda_ms(calls["sgd_pass"], iters=20, warmup=2),
             "host_us_per_launch": _pass_host_us_per_launch(calls["sgd_pass"], tensors),
             "plain": "sgd_mom_update per tensor", "library_ms": multi_ms,
             "library": "multi_sgd_mom_update (torch._foreach_*), multi_tensor_update's ms",
             "library_device_ms": library_device_ms(lambda: multi_sgd_mom_update(
                 st["weights"], st["grads"], st["moms"], lrs=SGD["lr"], wds=SGD["wd"],
                 momentum=SGD["momentum"], rescale_grad=SGD["rescale_grad"]), iters=10),
             **kernel_device_ms(calls["sgd_pass"], "sgd_mom", iters=10),
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "bytes": nbytes, "operations": ops}
    return axpy_t, sgd_t


# -- the generation path ------------------------------------------------------
def generation_prefill_qkv(gen):
    """q, k and v of one prefill cohort of ``GEN``'s model, as the engine
    dispatches it: (4, 1, 1024, 128) f32, two right-padded prompts (1024
    and 700 tokens) and two padding rows of token 0."""
    from mxnet_tpu_torch.serving.generation import tiny_lm_params

    p = {n: torch.from_numpy(a).cuda() for n, a in tiny_lm_params(**GEN).items()}
    b, s = GEN_ENGINE["prefill_max_batch"], GEN["max_len"]
    tokens = torch.zeros(b, s, dtype=torch.int64, device="cuda")
    tokens[0] = torch.randint(1, GEN["vocab"], (s,), generator=gen, device="cuda")
    tokens[1, :700] = torch.randint(1, GEN["vocab"], (700,), generator=gen, device="cuda")
    x = p["emb"][tokens] + p["pos"][None]
    return tuple((x @ p[w])[:, None] for w in ("wq", "wk", "wv"))


def _gen_prompts(n, seed, shared_every=2):
    """``n`` prompts of ``GEN``'s vocabulary: every ``shared_every``-th one
    (1, 3, ...) is the common ``GEN_SHARED_HEAD``-token head and a tail of 1
    to 64 tokens, so that its page-aligned prefix is the head; the others
    are 64 to 768 random tokens.  None for ``shared_every`` gives no head."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, GEN["vocab"], size=GEN_SHARED_HEAD)
    out = []
    for i in range(n):
        if shared_every and i % shared_every == 1:
            tail = rng.integers(1, GEN["vocab"], size=int(rng.integers(1, 65)))
            out.append(np.concatenate([head, tail]).astype(np.int32))
        else:
            out.append(rng.integers(1, GEN["vocab"], size=int(rng.integers(64, 769)))
                       .astype(np.int32))
    return out


def _serve(eng, prompts, greedy, on_submit=None):
    """Start every session, waiting for the oldest one still running
    whenever the slot pool sheds; returns the sessions and the seconds from
    the first start to the last token.  ``on_submit(i)`` runs after the
    i-th start."""
    from mxnet_tpu_torch.serving import KVPoolExhaustedError

    sessions, t0 = [], time.perf_counter()
    for i, prompt in enumerate(prompts):
        while True:
            try:
                sessions.append(eng.start_session(prompt, max_new_tokens=GEN_NEW_TOKENS,
                                                  greedy=greedy[i], seed=1000 + i))
                break
            except KVPoolExhaustedError:
                next(s for s in sessions if not s.done()).result(timeout=300)
        if on_submit is not None:
            on_submit(i)
    for s in sessions:
        tokens = s.result(timeout=300)
        if len(tokens) != GEN_NEW_TOKENS or not all(0 <= t < GEN["vocab"] for t in tokens):
            raise RuntimeError(f"session {s.session_id}: {len(tokens)} tokens, expected "
                               f"{GEN_NEW_TOKENS} in [0, {GEN['vocab']})")
    return sessions, time.perf_counter() - t0


def _p99(values):
    values = sorted(values)
    return values[min(len(values) - 1, int(0.99 * (len(values) - 1)))] if values else None


def _gen_engine(serving, model, name, **kw):
    return serving.GenerationEngine(model, name=name, max_len=GEN["max_len"],
                                    **{**GEN_ENGINE, **kw})


def run_slice_generation(library, serving):
    """The generation path at full width: warm, 64 sessions (48 greedy, 16
    sampled; half share a 256-token head), then 32 more with a hot reload
    after the 16th start.  Launch counts are set to 0 just before the warm
    and read after the last session.  Returns the engine (its traffic's
    prompts in ``engine.chip_prompts``) and the launches."""
    from mxnet_tpu_torch.ops.attention import flash_attention_fwd
    from mxnet_tpu_torch.telemetry.resources import LEDGER

    model = serving.tiny_lm(**GEN, device="cuda")
    eng = _gen_engine(serving, model, "chip-gen")
    owner = f"generation/{eng.name}"
    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    warmed = eng.warm()
    warm_s = time.perf_counter() - t0
    st0 = eng.stats()
    if st0["decode_compiles"] != 1 or warmed != GEN_BUCKETS:
        raise RuntimeError(f"warm: {st0['decode_compiles']} decode captures, buckets {warmed}")

    prompts = _gen_prompts(GEN_SESSIONS, seed=0)
    greedy = [i % 4 != 3 for i in range(GEN_SESSIONS)]   # 48 greedy, 16 sampled
    eng.metrics.drain_observations("intertoken_ms")
    sessions, wall = _serve(eng, prompts, greedy)
    st1 = eng.stats()
    gaps = eng.metrics.drain_observations("intertoken_ms")
    if st1["decode_compiles"] != st0["decode_compiles"]:
        raise RuntimeError(f"traffic captured the decode step again: {st0['decode_compiles']}"
                           f" -> {st1['decode_compiles']}")
    tokens = st1["tokens_emitted"] - st0["tokens_emitted"]
    if tokens != GEN_SESSIONS * GEN_NEW_TOKENS or st1["sessions_failed"]:
        raise RuntimeError(f"{tokens} tokens, {st1['sessions_failed']} sessions failed")
    px = st1["prefix_cache"]
    lookups = px["hits"] + px["misses"]

    # hot reload while sessions stream: the new version's warm (8 prefill
    # buckets and one capture) runs between the loop's ticks
    reload_prompts = _gen_prompts(GEN_RELOAD_SESSIONS, seed=1, shared_every=None)
    flip = {}

    def on_submit(i):
        if i == GEN_RELOAD_SESSIONS // 2 - 1:
            before = eng.stats()["decode_compiles"]
            t = time.perf_counter()
            flip["version"] = eng.load(serving.tiny_lm(**{**GEN, "seed": 1}, device="cuda"))
            flip["load_s"] = time.perf_counter() - t
            flip["captures_by_load"] = eng.stats()["decode_compiles"] - before
            flip["compiles_at_flip"] = eng.stats()["decode_compiles"]
            flip["after_flip"] = i + 1

    reload_sessions, _ = _serve(eng, reload_prompts, [True] * GEN_RELOAD_SESSIONS, on_submit)
    st2 = eng.stats()
    torch.cuda.synchronize()
    attention_launches = flash_attention_fwd.launches
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    if flip["captures_by_load"] != 1 or st2["decode_compiles"] != flip["compiles_at_flip"]:
        raise RuntimeError(f"hot reload: {flip['captures_by_load']} captures at load, "
                           f"{st2['decode_compiles'] - flip['compiles_at_flip']} after the flip")
    if st2["version"] != flip["version"] or len(st2["versions_resident"]) > 2:
        raise RuntimeError(f"hot reload: version {st2['version']}, resident "
                           f"{st2['versions_resident']}")
    if attention_launches != st2["prefill_dispatches"] or attention_launches == 0:
        raise RuntimeError(f"attention launched {attention_launches} times for "
                           f"{st2['prefill_dispatches']} prefill dispatches")
    if st2["kv"]["slots_in_use"] or LEDGER.snapshot()["owners"][owner]["kv_pages"]:
        raise RuntimeError(f"after the traffic: {st2['kv']}")

    # the sessions started after the flip, unbatched on a second engine of
    # the new weights without a prefix cache: equal token for token
    ref = _gen_engine(serving, eng._versions[flip["version"]], "chip-gen-ref",
                      prefix_cache_entries=0)
    try:
        ref.warm()
        after = reload_sessions[flip["after_flip"]:][:4]
        mismatched = [s.session_id for s in after
                      if ref.generate(s.prompt, max_new_tokens=GEN_NEW_TOKENS) != s.tokens]
    finally:
        ref.close()
    if mismatched:
        raise RuntimeError(f"sessions after the flip differ from unbatched runs: {mismatched}")
    emit("slice_generation", model="tiny_lm", **GEN, engine=GEN_ENGINE, dtype="float32",
         sessions=GEN_SESSIONS, new_tokens=GEN_NEW_TOKENS, greedy=sum(greedy),
         shared_head_tokens=GEN_SHARED_HEAD, warm_seconds=warm_s, warmed_buckets=warmed,
         generate_tokens_per_sec=tokens / wall, generate_p99_intertoken_ms=_p99(gaps),
         intertoken_samples=len(gaps), traffic_seconds=wall,
         prefill_tokens=st1["prefill_tokens"], prefill_seconds=st1["prefill_seconds"],
         prefill_tokens_per_sec=st1["prefill_tokens"] / st1["prefill_seconds"],
         decode_steps=st1["decode_steps"], max_active=st1["max_active"],
         prefix_hits=px["hits"], prefix_lookups=lookups, prefix_hit_rate=px["hits"] / lookups,
         decode_compiles_before=st0["decode_compiles"], decode_compiles_after=st1["decode_compiles"],
         hot_reload={**flip, "decode_compiles_end": st2["decode_compiles"],
                     "sessions": GEN_RELOAD_SESSIONS,
                     "after_flip_equal_to_unbatched": len(after)},
         prefill_dispatches=st2["prefill_dispatches"], attention_launches=attention_launches,
         launches=launches, kv_after=st2["kv"])
    eng.chip_prompts = (prompts, greedy)
    return eng, launches


def run_parity_generation(serving):
    """A narrow ``tiny_lm`` with the same weights on the card and the CPU:
    prefill and decode logits and the arena at ``GEN_PARITY_TOL``; greedy
    tokens equal until a step whose top two logits lie within it; batched
    equal to unbatched bit for bit on the card, greedy and seeded."""
    from mxnet_tpu_torch.serving.generation import tiny_lm_params

    c = NARROW_GEN
    arrays = tiny_lm_params(c["vocab"], c["d_model"], c["max_len"], seed=3)
    models = {d: serving.tiny_lm(**c, device=d, params=arrays) for d in ("cuda", "cpu")}
    rng = np.random.default_rng(4)
    worst = {}

    def close(name, got, want):
        want = want.float()
        got = got.float().cpu()
        atol = GEN_PARITY_TOL * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=GEN_PARITY_TOL, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
        worst[name] = (got - want).abs().max().item()

    lengths, bucket = [37, 64, 5, 1], 64
    tokens = torch.zeros(4, bucket, dtype=torch.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = torch.from_numpy(rng.integers(1, c["vocab"], size=n))
    mask = (torch.arange(bucket)[None] < torch.tensor(lengths)[:, None]).float()
    with torch.no_grad():
        out = {d: m.prefill_fn(m.params, tokens.to(d), mask.to(d)) for d, m in models.items()}
        for i, n in enumerate(lengths):
            close(f"prefill_logits[{i}]", out["cuda"][1][i, :n], out["cpu"][1][i, :n])
        for name in ("k", "v"):
            close(f"prefill_{name}", out["cuda"][0][name], out["cpu"][0][name])
        arena0 = {n: torch.from_numpy(rng.standard_normal((4, c["max_len"], c["d_model"]))
                                      .astype(np.float32)) for n in ("k", "v")}
        dtok = torch.tensor([3, 60, 17, 1])
        dpos = torch.tensor([0, 7, 64, c["max_len"] - 1])
        dec = {}
        for d, m in models.items():
            arena = {n: a.clone().to(d) for n, a in arena0.items()}
            dec[d] = m.decode_fn(m.params, arena, dtok.to(d), dpos.to(d))
        close("decode_logits", dec["cuda"][0], dec["cpu"][0])
        for name in ("k", "v"):
            close(f"decode_arena_{name}", dec["cuda"][1][name], dec["cpu"][1][name])

    prompts = [rng.integers(1, c["vocab"], size=n).astype(np.int32) for n in (6, 13, 3, 29, 11, 40)]
    kw = dict(slots=8, page_tokens=8, kv_budget_mb=8, prefix_cache_entries=0, max_len=c["max_len"])

    def run(device, batched, greedy):
        eng = serving.GenerationEngine(models[device], name=f"chip-gp-{device}-{batched}-{greedy}",
                                       **kw)
        try:
            eng.warm()
            if batched:
                ss = [eng.start_session(p, max_new_tokens=16, greedy=greedy, seed=7 + i)
                      for i, p in enumerate(prompts)]
                out = [s.result(timeout=120) for s in ss]
                if eng.stats()["max_active"] < 2:
                    raise RuntimeError("the batched run never shared a decode step")
                return out
            return [eng.generate(p, max_new_tokens=16, greedy=greedy, seed=7 + i)
                    for i, p in enumerate(prompts)]
        finally:
            eng.close()

    card = run("cuda", False, True)
    host = run("cpu", False, True)
    cpu = models["cpu"]
    diverged = 0
    for p, g, w in zip(prompts, card, host):
        for t, (a, b) in enumerate(zip(g, w)):
            if a == b:
                continue
            seq = torch.from_numpy(np.concatenate([p, np.asarray(w[:t], np.int32)])[None]
                                   .astype(np.int64))
            with torch.no_grad():
                logits = cpu.prefill_fn(cpu.params, seq, torch.ones(seq.shape))[1][0, -1]
            top = torch.topk(logits, 2).values
            margin = (top[0] - top[1]).item() / max(1.0, logits.abs().max().item())
            if margin > GEN_PARITY_TOL:
                raise RuntimeError(f"greedy token {t} differs ({a} on the card, {b} on the CPU)"
                                   f" where the top two logits are {margin:.3g} apart")
            diverged += 1
            break
    bitwise = {}
    for greedy in (True, False):
        unbatched = card if greedy else run("cuda", False, False)
        batched = run("cuda", True, greedy)
        if batched != unbatched:
            raise RuntimeError(f"batched {'greedy' if greedy else 'seeded'} generations on the "
                               "card differ from unbatched ones")
        bitwise["greedy" if greedy else "seeded"] = True
    emit("parity_generation", **c, rtol=GEN_PARITY_TOL, atol_per_unit_max=GEN_PARITY_TOL,
         max_abs_err=worst, sessions=len(prompts), greedy_equal=len(prompts) - diverged,
         greedy_diverged_within_tol=diverged, batched_equal_unbatched_bitwise=bitwise)


def _decode_inputs(eng):
    """A scratch arena and device tokens and positions at the engine's shape."""
    arena = {n: a.clone() for n, a in eng._arena.items()}
    tokens = torch.randint(1, GEN["vocab"], (eng.slots,), device="cuda")
    pos = torch.randint(0, GEN["max_len"], (eng.slots,), device="cuda")
    return arena, tokens, pos


def time_generation_host(eng):
    """Before the process's first profiler session: the decode step by CUDA
    events (the graph's replay alone, a tick's replay with its input copies,
    and the eager step over a scratch arena), one full prefill dispatch at
    (4, 1024), and the slice's traffic once more, unprofiled, from a cold
    prefix cache.  All of it on the engine's loop thread."""
    step = eng._decode_fns[eng.stats()["version"]]
    tokens_np = np.zeros(eng.slots, np.int32)
    arena, tokens, pos = _decode_inputs(eng)
    model = step.model
    prefill_tok = torch.randint(1, GEN["vocab"], (GEN_ENGINE["prefill_max_batch"],
                                                  GEN["max_len"]), device="cuda")
    mask = torch.ones(prefill_tok.shape, device="cuda")

    def timings():
        with torch.no_grad():
            return {"graph_replay_ms": cuda_ms(step.graph.replay, iters=200, warmup=10),
                    "replayed_ms": cuda_ms(lambda: step(tokens_np, tokens_np), iters=200,
                                           warmup=10),
                    "eager_ms": cuda_ms(lambda: step.eager(arena, tokens, pos), iters=200,
                                        warmup=10),
                    "prefill_dispatch_ms_4x1024": cuda_ms(
                        lambda: model.prefill_fn(model.params, prefill_tok, mask), iters=10,
                        warmup=2)}

    out = eng._on_loop(timings)
    out["prefill_dispatch_tokens_per_sec"] = (prefill_tok.numel()
                                              / out["prefill_dispatch_ms_4x1024"] * 1e3)
    t0 = time.perf_counter()
    _gen_traffic(eng)
    out["traffic_unprofiled_seconds"] = time.perf_counter() - t0
    return out


def _gen_traffic(eng):
    """The slice's traffic again, from a cold prefix cache as the slice's was."""
    eng.prefix_cache.clear()
    prompts, greedy = eng.chip_prompts
    return _serve(eng, prompts, greedy)


def time_generation(eng, entry, host):
    """The attention kernel at the prefill's shape beside its plain version,
    SDPA and the bound, and a profiled pass of the slice's traffic for the
    device's idle share, within the pass and against ``host``'s unprofiled
    one.  Then the engine closes and the ledger must be at zero."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.telemetry.resources import LEDGER

    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = generation_prefill_qkv(gen)
    b, h, s, d = q.shape
    ops = 4 * d * b * h * s * (s + 1) // 2
    nbytes = 4 * q.numel() * 4 + 2 * b * h * s * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * ops / TF32_OPS_PER_S * 1e3
    attn = {"shape": [b, h, s, d], "causal": True, "dtype": "float32",
            "ms": cuda_ms(lambda: entry.kernel(q, k, v, True), iters=50, warmup=5),
            "plain_ms": cuda_ms(lambda: entry.plain(q, k, v, True), iters=10, warmup=2),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                                  iters=50, warmup=5),
            "library": "F.scaled_dot_product_attention(is_causal=True), o only",
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops, "tensor_core_operations": 3 * ops,
            **kernel_device_ms(lambda: entry.kernel(q, k, v, True), "flash_attn_mma_kernel",
                               iters=20),
            "library_device_ms": library_device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), iters=20)}

    prof = step_breakdown(lambda: _gen_traffic(eng), iters=1, top=8)
    busy_s = prof["device_busy_ms_per_step"] / 1e3
    eng.close()
    owners = LEDGER.snapshot()["owners"].get(f"generation/{eng.name}", {})
    if any(owners.values()) or eng.stats()["kv"]["slots_in_use"]:
        raise RuntimeError(f"after close: ledger {owners}, pool {eng.stats()['kv']}")
    emit("timing_generation", tf32=False, **host, attention_prefill=attn,
         traffic_profiled_seconds=prof["wall_ms_per_step"] / 1e3, device_busy_seconds=busy_s,
         device_idle_share=prof["device_idle_share"],
         device_idle_share_vs_unprofiled=1.0 - busy_s / host["traffic_unprofiled_seconds"],
         traffic_profile={k: prof[k] for k in ("by_kind", "top_kernels")},
         ledger_after_close=owners)
    return attn


# -- the serving path ----------------------------------------------------------
SERVE = {"batch": 32, "latency_ms": 10.0, "queue_depth": 256, "requests": 64,
         "image": IMAGE, "rate_x": 1.2}
SERVE_TOL = 1e-5          # served rows against net(x) alone, of the output's scale
SERVE_PROFILED_SECONDS = 2.0
SERVE_LN = {"embed": 768, "hidden": 3072, "classes": 10, "batch": 8, "requests": 16}
SERVE_GEN_PROMPTS = 8


def _resnet18(mx, vision, Xavier, seed):
    """``resnet18_v1()`` on the card with Xavier weights from a CPU generator
    seeded with ``seed``, its deferred shapes finished by one forward."""
    gpu = mx.gpu(0)
    net = vision.resnet18_v1()
    net.initialize(Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(seed))
    with mx.autograd.pause():
        net(mx.nd.zeros((1, 3, IMAGE, IMAGE), ctx=gpu))
    return net


def _serve_requests(server, name, xs, timeout=300):
    futs = [server.predict_async(name, {"data": x}) for x in xs]
    return np.stack([f.result(timeout)[0] for f in futs])


def _threads_left(names):
    import threading
    deadline = time.monotonic() + 10
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.is_alive() and any(n in t.name for n in names)]
        if not alive or time.monotonic() > deadline:
            return alive
        time.sleep(0.01)


def _fresh_ladders(mx):
    """Forget the process's measured batch sizes and planned ladders, as a
    new server process starts: each phase plans from its own traffic."""
    mx.compile.STATS.reset()
    mx.compile.clear_ladders()
    mx.compile.clear_warmed()


def _close_server(server):
    server.shutdown(timeout=30)
    left = _threads_left([server.name])
    if left:
        raise RuntimeError(f"server {server.name}: threads alive after shutdown: {left}")


def run_slice_serving(mx, vision, Xavier, library):
    """Bench's ``measure_serving`` model on the card, under cuDNN's
    deterministic algorithms: ``resnet18_v1()`` loaded through
    ``ModelServer.load(block=)``, its ladder captured, each bucket's replay
    bit-equal to its executor's eager forward, 64 single requests equal to
    ``net(x)`` alone within ``SERVE_TOL`` of the output's scale, the
    exported JSON loaded through ``prefix=`` bit-equal bucket by bucket, a
    hot reload under traffic with no capture after its flip.  Returns the
    net and the launches."""
    return _deterministic(_slice_serving, mx, vision, Xavier, library)


def _slice_serving(mx, vision, Xavier, library):
    from mxnet_tpu_torch import serving
    gpu, c = mx.gpu(0), SERVE
    _fresh_ladders(mx)
    net = _resnet18(mx, vision, Xavier, seed=0)
    n_params = sum(int(np.prod(p.shape)) for p in net.collect_params().values()
                   if p.grad_req != "null")
    server = serving.ModelServer(max_batch_size=c["batch"], max_latency_ms=c["latency_ms"],
                                 max_queue_depth=c["queue_depth"], name="chip-serve")
    sig = [("data", (3, c["image"], c["image"]), "float32")]
    try:
        if server.ctx != gpu:
            raise RuntimeError(f"a server without ctx serves on {server.ctx}, not {gpu}")
        t0 = time.perf_counter()
        server.load("resnet18", block=net)
        trace_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        library.reset_launches()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        buckets = server.warm("resnet18", sample_signature=sig)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        ladder_bytes = torch.cuda.memory_allocated() - mem0
        weight_bytes = sum(a._data.numel() * a._data.element_size() for a in
                           server.repository.get("resnet18").params_on(gpu).values())
        st = server.stats()["executor_cache"]["per_model"]["resnet18"]
        if buckets != [1, 2, 4, 8, 16, 32] or st["captures"] != len(buckets):
            raise RuntimeError(f"warm: buckets {buckets}, {st['captures']} captures")

        # every bucket: the replay against its own executor's eager forward
        gen = torch.Generator().manual_seed(7)
        xs = torch.randn(c["requests"], 3, c["image"], c["image"], generator=gen).numpy()
        entries = {e.bucket: e for e in server.cache.entries("resnet18")}
        replay_vs_eager = {}
        for b, entry in sorted(entries.items()):
            got = entry.run_padded({"data": xs[:b]}, b)[0]
            want = entry.executor.forward(is_train=False, data=xs[:b])[0].asnumpy()
            replay_vs_eager[b] = bool(np.array_equal(got, want))
        if not all(replay_vs_eager.values()):
            raise RuntimeError(f"replay against eager forward, bit for bit: {replay_vs_eager}")

        # 64 single requests, batched by the server, against net(x) alone
        batches0 = server.metrics.get("batches_total")
        served = _serve_requests(server, "resnet18", xs)
        with mx.autograd.pause():
            alone = np.stack([net(mx.nd.array(x[None], ctx=gpu)).asnumpy()[0] for x in xs])
        scale = float(np.abs(alone).max())
        served_err = float(np.abs(served - alone).max()) / scale
        batches = server.metrics.get("batches_total") - batches0
        if served.shape != (c["requests"], 1000) or not np.isfinite(served).all() \
                or served_err > SERVE_TOL:
            raise RuntimeError(f"served rows against net(x) alone: shape {served.shape}, "
                               f"max|err|/scale {served_err}")

        # the exported JSON through prefix=, bucket by bucket, bit for bit
        prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                              "_build", "serve_resnet18")
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        net.export(prefix)
        try:
            server.load("resnet18_json", prefix=prefix)
            server.warm("resnet18_json", sample_signature=sig)
        finally:
            for suffix in ("-symbol.json", "-0000.params"):
                os.remove(prefix + suffix)
        json_entries = {e.bucket: e for e in server.cache.entries("resnet18_json")}
        json_equal = {b: bool(np.array_equal(entries[b].run_padded({"data": xs[:b]}, b)[0],
                                              json_entries[b].run_padded({"data": xs[:b]},
                                                                         b)[0]))
                      for b in buckets}
        server.unload("resnet18_json")
        if not all(json_equal.values()):
            raise RuntimeError(f"prefix= of the export against block=, bit for bit: "
                               f"{json_equal}")

        # hot reload while traffic runs: the new ladder is captured before the
        # flip, beside the old version's replays; none after it
        net2 = _resnet18(mx, vision, Xavier, seed=1)
        import threading
        stop, seen, errors = threading.Event(), [], []

        def traffic():
            deadline = time.monotonic() + 120
            while not stop.is_set() and time.monotonic() < deadline:
                try:
                    seen.append(server.predict("resnet18", {"data": xs[0]}, wait_s=120)[0])
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))
                    return

        t = threading.Thread(target=traffic, name="chip-serve-traffic")
        t.start()
        try:
            time.sleep(0.2)
            captures_before = server.stats()["executor_cache"]["per_model"]["resnet18"][
                "captures"]
            served_before_load = len(seen)
            t0 = time.perf_counter()
            version = server.load("resnet18", block=net2)
            reload_s = time.perf_counter() - t0
            served_during_load = len(seen) - served_before_load
            captures_at_flip = server.stats()["executor_cache"]["per_model"]["resnet18"][
                "captures"]
            n_flip = len(seen)
            deadline = time.monotonic() + 60
            while len(seen) < n_flip + 20 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            stop.set()
            t.join(120)
        if t.is_alive() or errors:
            raise RuntimeError(f"traffic during the reload: alive {t.is_alive()}, {errors}")
        after = _serve_requests(server, "resnet18", xs[:8])
        with mx.autograd.pause():
            alone2 = np.stack([net2(mx.nd.array(x[None], ctx=gpu)).asnumpy()[0]
                               for x in xs[:8]])
        reload_err = float(np.abs(after - alone2).max()) / float(np.abs(alone2).max())
        st = server.stats()
        per = st["executor_cache"]["per_model"]["resnet18"]
        reload = {"version": version, "seconds": reload_s,
                  "captures_by_reload": captures_at_flip - captures_before,
                  "captures_after_flip": per["captures"] - captures_at_flip,
                  "requests_served_during_reload": served_during_load,
                  "requests_after_flip": len(seen) - n_flip, "max_abs_err_rel": reload_err,
                  "versions_cached": sorted({e.key[1] for e in
                                             server.cache.entries("resnet18")})}
        if reload["captures_by_reload"] != len(buckets) or reload["captures_after_flip"] \
                or reload_err > SERVE_TOL or version != 2:
            raise RuntimeError(f"hot reload: {reload}")
        # every batch after the captures replayed: the bucket checks and the
        # runner's batches, nothing else
        runs = len(buckets) + st["batches_total"] + len(buckets)
        if per["replays"] != runs:
            raise RuntimeError(f"replays {per['replays']}, runs {runs}")
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in library.KERNELS.items()}
        emit("slice_serving", model="resnet18_v1", trainable_parameters=n_params,
             image=c["image"], classes=1000, dtype="float32", tf32=False,
             cudnn_deterministic=True, max_batch_size=c["batch"],
             max_latency_ms=c["latency_ms"], max_queue_depth=c["queue_depth"],
             ctx=str(server.ctx), trace_seconds=trace_s, warm_seconds=warm_s,
             buckets=buckets, captures=len(buckets), ladder_allocated_bytes=ladder_bytes,
             weight_bytes=weight_bytes, replay_equals_eager=replay_vs_eager,
             requests=c["requests"], batches=batches, served_max_abs_err_rel=served_err,
             served_tol=SERVE_TOL, export_prefix_equals_block=json_equal, hot_reload=reload,
             executor_cache=st["executor_cache"], launches=launches)
        return net, launches
    finally:
        _close_server(server)


def _poisson(server, name, sample, rate, seconds, seed):
    """Open-loop arrivals at ``rate`` for ``seconds`` (bench.py's window):
    offered, completed, shed and the window's seconds."""
    rng = np.random.default_rng(seed)
    futures, shed = [], 0
    t_begin = time.perf_counter()
    t_next, t_end = t_begin, t_begin + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        t_next += rng.exponential(1.0 / rate)
        if t_next > now:
            time.sleep(t_next - now)
        try:
            futures.append(server.predict_async(name, {"data": sample}))
        except Exception as e:  # noqa: BLE001 - only a shed is counted
            from mxnet_tpu_torch.serving import ServingOverloadError
            if not isinstance(e, ServingOverloadError):
                raise
            shed += 1
    completed = 0
    for f in futures:
        f.result(600)
        completed += 1
    return {"offered": len(futures) + shed, "completed": completed, "shed": shed,
            "window_s": time.perf_counter() - t_begin}


def _timing_server(net, name):
    """A server of ``net`` as bench.py's ``measure_serving`` builds it (under
    cuDNN's default algorithms), its ladder captured."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config, serving
    c = SERVE
    _fresh_ladders(mx)
    server = serving.ModelServer(max_batch_size=config.get("BENCH_SERVE_BATCH"),
                                 max_latency_ms=config.get("BENCH_SERVE_LATENCY_MS"),
                                 max_queue_depth=max(256, 4 * c["batch"]), name=name)
    server.load("resnet18", block=net)
    buckets = server.warm("resnet18", sample_signature=[
        ("data", (3, c["image"], c["image"]), "float32")])
    return server, buckets


def time_serving(net):
    """``timing_serving``'s numbers, before the process's first profiler
    session: a server of ``net``, a full bucket, the closed-loop probe
    (4 x 32 requests), then Poisson arrivals at 1.2x the probe for
    ``BENCH_SERVE_SECONDS``.  The device's idle share over the window is the
    share not covered by the window's replays at each bucket's replay time
    by CUDA events.  Then the bucket-32 replay and the same batch's eager
    executor forward by events, and the host's time in one batch."""
    from mxnet_tpu_torch import config
    c = SERVE
    seconds = config.get("BENCH_SERVE_SECONDS")
    server, buckets = _timing_server(net, "chip-serve-timing")
    try:
        return _time_serving(server, buckets, seconds)
    finally:
        _close_server(server)


def _time_serving(server, buckets, seconds):
    from mxnet_tpu_torch import config
    c = SERVE
    sample = np.random.default_rng(0).normal(size=(3, c["image"], c["image"])).astype(
        np.float32)
    _serve_requests(server, "resnet18", [sample] * c["batch"])
    t0 = time.perf_counter()
    _serve_requests(server, "resnet18", [sample] * (4 * c["batch"]))
    probe_rps = 4 * c["batch"] / (time.perf_counter() - t0)
    rate = config.get("BENCH_SERVE_RATE") or c["rate_x"] * probe_rps
    entries = {e.bucket: e for e in server.cache.entries("resnet18")}
    replays0 = {b: e.replays for b, e in entries.items()}
    server.metrics.drain_latencies()
    batches0 = server.metrics.get("batches_total")
    window = _poisson(server, "resnet18", sample, rate, seconds, seed=0)
    lat = sorted(server.metrics.drain_latencies())
    snap = server.stats()
    replays = {b: e.replays - replays0[b] for b, e in entries.items()}
    graph_ms = {b: cuda_ms(e.graph.replay, iters=20, warmup=3) for b, e in entries.items()}
    busy_s = sum(replays[b] * graph_ms[b] for b in entries) / 1e3
    big = entries[c["batch"]]
    feed = {"data": np.stack([sample] * c["batch"])}
    eager_ms = cuda_ms(lambda: big.executor.forward(is_train=False), iters=20, warmup=3)
    t0 = time.perf_counter()
    for _ in range(20):
        big.run_padded(feed, c["batch"])
    run_padded_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        np.stack([sample] * c["batch"])
    stack_ms = (time.perf_counter() - t0) / 20 * 1e3
    out = {"resnet18_serve_img_per_sec": window["completed"] / window["window_s"],
           "p50_ms": _percentile(lat, 50), "p99_ms": _percentile(lat, 99),
           "latency_samples": len(lat), "batch_occupancy": snap["batch_occupancy"],
           "offered": window["offered"], "completed": window["completed"],
           "shed": window["shed"], "window_s": window["window_s"],
           "arrival_rate_rps": rate, "probe_closed_loop_rps": probe_rps,
           "max_batch_size": config.get("BENCH_SERVE_BATCH"),
           "max_latency_ms": config.get("BENCH_SERVE_LATENCY_MS"), "buckets": buckets,
           "batches_in_window": snap["batches_total"] - batches0,
           "replays_in_window_by_bucket": replays, "graph_replay_ms_by_bucket": graph_ms,
           "device_busy_seconds_by_replay_events": busy_s,
           "device_idle_share": 1.0 - busy_s / window["window_s"],
           "replay_ms_bucket32": graph_ms[c["batch"]], "eager_forward_ms_bucket32": eager_ms,
           "run_padded_host_ms_bucket32": run_padded_ms, "stack_32_samples_host_ms": stack_ms,
           "executor_cache": snap["executor_cache"]["per_model"]["resnet18"]}
    if not (out["completed"] and all(math.isfinite(v) for v in graph_ms.values())):
        raise RuntimeError(f"timing_serving: {out}")
    return out


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))]


def profile_serving(net, out):
    """The device's idle share from a profiled Poisson window of
    ``SERVE_PROFILED_SECONDS`` at the timed window's rate on a new server of
    ``net`` (the profiler slows the host, so this share overstates an
    unprofiled window's), then ``timing_serving``'s line."""
    server, _ = _timing_server(net, "chip-serve-profiled")
    try:
        prof = step_breakdown(lambda: _poisson(server, "resnet18", np.zeros(
            (3, SERVE["image"], SERVE["image"]), np.float32), out["arrival_rate_rps"],
            SERVE_PROFILED_SECONDS, seed=1), iters=1, top=8)
    finally:
        _close_server(server)
    emit("timing_serving", tf32=False, cudnn_deterministic=False, **out,
         profiled_window={"seconds": SERVE_PROFILED_SECONDS,
                          "device_idle_share": prof["device_idle_share"],
                          "by_kind": prof["by_kind"], "top_kernels": prof["top_kernels"]})
    return out


def _failed_capture(server, name, sample):
    """A capture made to fail (the ``serving/executor_cache/capture``
    failpoint, once) fails its request with ``GraphCaptureError``: no replay
    and no eager forward answer it.  The next request captures and is
    served.  The entry is dropped afterwards, so the ladder starts clean."""
    from mxnet_tpu_torch import chaos
    from mxnet_tpu_torch.serving import GraphCaptureError
    chaos.reset()
    chaos.arm("serving/executor_cache/capture", "raise", hits=1, count=1)
    try:
        server.predict(name, {"data": sample}, wait_s=120)
        raised = None
    except GraphCaptureError as e:
        raised = type(e).__name__
    finally:
        chaos.reset()
    per = server.stats()["executor_cache"]["per_model"][name]
    failed = {"raised": raised, "captures": per["captures"], "replays": per["replays"]}
    out = server.predict(name, {"data": sample}, wait_s=120)[0]
    per = server.stats()["executor_cache"]["per_model"][name]
    failed.update(captures_after_retry=per["captures"], replays_after_retry=per["replays"])
    server.cache.evict_model((name,))
    if raised != "GraphCaptureError" or failed["captures"] or failed["replays"] or \
            failed["captures_after_retry"] != 1 or failed["replays_after_retry"] != 1 or \
            not np.isfinite(out).all():
        raise RuntimeError(f"a failed capture: {failed}")
    return failed


def run_slice_serving_kernels(mx, library, serving_mod, Xavier):
    """Kernels behind the server: an exported ``HybridSequential(Dense(3072),
    LayerNorm(), Dense(10))`` served through ``prefix=`` (layernorm at each
    bucket's warm-up run and capture, none at the replays; the rows equal the
    plain version at the kernel's tolerance), and ``tiny_lm`` at GPT-2's
    vocabulary and context behind ``load_generator``, whose ``generate``
    equals ``slice_generation``'s engine alone token for token (one
    attention launch a prefill dispatch).  Returns the launches."""
    from mxnet_tpu_torch.ops.attention import flash_attention_fwd
    from mxnet_tpu_torch.ops.layer_norm import plain_layer_norm_fwd
    gpu, nn, c = mx.gpu(0), mx.gluon.nn, SERVE_LN
    net = nn.HybridSequential(prefix="servln_")
    with net.name_scope():
        net.add(nn.Dense(c["hidden"], in_units=c["embed"]),
                nn.LayerNorm(in_channels=c["hidden"]),
                nn.Dense(c["classes"], in_units=c["hidden"]))
    net.initialize(Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(5))
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                          "_build", "serve_ln")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    net.export(prefix)
    server = serving_mod.ModelServer(max_batch_size=c["batch"], max_latency_ms=5.0,
                                     name="chip-serve-ln")
    try:
        server.load("ln", prefix=prefix)
        for suffix in ("-symbol.json", "-0000.params"):
            os.remove(prefix + suffix)
        failed_capture = _failed_capture(server, "ln", np.zeros(c["embed"], np.float32))
        torch.cuda.synchronize()
        library.reset_launches()
        buckets = server.warm("ln", sample_signature=[("data", (c["embed"],), "float32")])
        torch.cuda.synchronize()
        at_capture = {name: k.launches for name, k in library.KERNELS.items()}
        library.reset_launches()
        xs = torch.randn(c["requests"], c["embed"], generator=torch.Generator().manual_seed(6))
        got = torch.from_numpy(_serve_requests(server, "ln", xs.numpy()))
        torch.cuda.synchronize()
        at_replays = {name: k.launches for name, k in library.KERNELS.items()}
        d1, ln, d2 = net[0], net[1], net[2]
        with torch.no_grad():
            h = xs.to(gpu.torch_device) @ d1.weight.detach().t() + d1.bias.detach()
            y = plain_layer_norm_fwd(h, ln.gamma.detach(), ln.beta.detach(), 1e-5)[0]
            want = (y @ d2.weight.detach().t() + d2.bias.detach()).cpu()
        rtol, atol = library.get("layernorm").tolerance(torch.float32)
        ln_err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=rtol, atol=atol)
        st = server.stats()["executor_cache"]["per_model"]["ln"]
    finally:
        _close_server(server)
    want_capture = {**{k: 0 for k in at_capture}, "layernorm": 2 * len(buckets)}
    want_replays = {k: 0 for k in at_replays}
    if at_capture != want_capture or at_replays != want_replays or not ok:
        raise RuntimeError(f"slice_serving_kernels: launches at capture {at_capture}, at "
                           f"replays {at_replays}, max|err| {ln_err}")

    # generation behind the server, against the engine alone
    model = serving_mod.tiny_lm(**GEN, device="cuda")
    gen_server = serving_mod.ModelServer(name="chip-serve-gen")
    prompts = _gen_prompts(SERVE_GEN_PROMPTS, seed=3, shared_every=None)
    try:
        torch.cuda.synchronize()
        library.reset_launches()
        gen_server.load_generator("lm", model, warm=True, max_len=GEN["max_len"], **GEN_ENGINE)
        sessions = [gen_server.generate_async("lm", p, max_new_tokens=GEN_NEW_TOKENS)
                    for p in prompts]
        tokens = [s.result(timeout=300) for s in sessions]
        torch.cuda.synchronize()
        gen_launches = {name: k.launches for name, k in library.KERNELS.items()}
        gst = gen_server.generator("lm").stats()
    finally:
        _close_server(gen_server)
    ref = _gen_engine(serving_mod, model, "chip-serve-gen-ref", prefix_cache_entries=0)
    try:
        ref.warm()
        want_tokens = [ref.generate(p, max_new_tokens=GEN_NEW_TOKENS) for p in prompts]
    finally:
        ref.close()
    equal = [a == b for a, b in zip(tokens, want_tokens)]
    if gen_launches["attention"] != gst["prefill_dispatches"] or not all(equal) \
            or gen_launches["attention"] == 0:
        raise RuntimeError(f"generation behind the server: {gen_launches['attention']} "
                           f"attention launches for {gst['prefill_dispatches']} prefill "
                           f"dispatches, equal to the engine alone {equal}")
    emit("slice_serving_kernels", block="HybridSequential(Dense(3072), LayerNorm(), Dense(10))",
         source="prefix= of export", embed=c["embed"], requests=c["requests"],
         failed_capture=failed_capture, buckets=buckets, launches_at_capture=at_capture, launches_at_replays=at_replays,
         layernorm_max_abs_err=ln_err, tolerance=[rtol, atol], executor_cache=st,
         generation={"model": "tiny_lm", **GEN, "engine": GEN_ENGINE,
                     "sessions": len(prompts), "new_tokens": GEN_NEW_TOKENS,
                     "equal_to_engine_alone": all(equal), "launches": gen_launches,
                     "prefill_dispatches": gst["prefill_dispatches"],
                     "decode_compiles": gst["decode_compiles"]})
    return {"layernorm_capture": at_capture["layernorm"],
            "layernorm_replays": at_replays["layernorm"],
            "attention_generate": gen_launches["attention"]}


# slice_data: bench.py's _resnet50_symbol(1000) through Module.fit, fed from
# DATA_RECORDS raw-pixel records (IRHeader + 224x224x3 uint8, seed 0) by
# RecordFileSource -> DataPipeline -> WindowFeed, MXNET_SCAN_STEPS windows
DATA_RECORDS = 512               # 16 batches of BATCH, about 77 MB
DATA_SCAN = 2
DATA_WORKERS = 2
DATA_MEAN = (123.68, 116.28, 103.53)
DATA_STD = (58.395, 57.12, 57.375)
DATA_FAIL_HIT = 5                # the call of io/reader/read at which one reader dies
# timing_data_pipeline: bench.py measure_data_pipeline's sizes and its gate
PIPE = {"layers": 16, "width": 256, "features": 64, "classes": 10, "batch": 512, "k": 8,
        "steps": 16, "workers": 2, "epochs": 3, "long_steps": 256}
PIPE_REFERENCE_BUDGET_PCT = 5.0  # the JAX package's gate on data_wait_pct (its own)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def _write_records(mx, path, n, seed=0):
    """``n`` raw-pixel records, IRHeader (a label in [0, 1000)) and a
    224x224x3 uint8 image each, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 1000, n)
    w = mx.recordio.MXRecordIO(path, "w")
    try:
        for i in range(n):
            img = rng.randint(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
            w.write(mx.recordio.pack((0, float(labels[i]), i, 0), img.tobytes()))
    finally:
        w.close()


def _host_batches(it):
    """Every batch of ``it`` as (index, data, label) numpy arrays; a pipeline
    is closed after."""
    try:
        return [(None if b.index is None else np.asarray(b.index), b.data[0].asnumpy(),
                 b.label[0].asnumpy()) for b in it]
    finally:
        if hasattr(it, "close"):
            it.close()


def _batches_differ(got, want):
    """The positions where two batch sequences differ (a length mismatch is
    position -1)."""
    if len(got) != len(want):
        return [-1]
    return [i for i, ((gi, gd, gl), (wi, wd, wl)) in enumerate(zip(got, want))
            if not (np.array_equal(gd, wd) and np.array_equal(gl, wl)
                    and (gi is None or wi is None or np.array_equal(gi, wi)))]


def _data_fit(mx, library, symbol, params, path, workers, fail_hit=None):
    """Module.fit of ``symbol`` from ``params`` over a DataPipeline(workers)
    of the records, ``DATA_SCAN``-step windows: epoch 1 (it captures the
    window), then epoch 2 timed.  ``fail_hit`` arms one reader to die at
    that call of ``io/reader/read`` in epoch 1.  Returns the module, its
    state and losses after epoch 1, epoch 2's seconds and data-wait
    seconds, and the kernels' launches in epoch 1."""
    from mxnet_tpu_torch import chaos, telemetry
    src = mx.io_pipeline.RecordFileSource(path, (3, IMAGE, IMAGE), BATCH, mean=DATA_MEAN,
                                          std=DATA_STD)
    pipe = mx.io_pipeline.DataPipeline(src, workers=workers, seed=0)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    metric = _step_losses(mx)
    fit = {"eval_metric": metric, "kvstore": None, "optimizer": "sgd",
           "optimizer_params": MODULE_SGD}
    try:
        with _Env(MXNET_FUSED_STEP=1, MXNET_SCAN_STEPS=DATA_SCAN, MXNET_DATA_WORKERS=workers):
            if fail_hit:
                chaos.arm("io/reader/read", "raise", hits=fail_hit, count=1)
            rebalances = telemetry._DATA_REBALANCE.value()
            library.reset_launches()
            mod.fit(pipe, num_epoch=1, arg_params=params[0], aux_params=params[1], **fit)
            torch.cuda.synchronize()
            launches = {k: v.launches for k, v in library.KERNELS.items()}
            rebalances = telemetry._DATA_REBALANCE.value() - rebalances
            chaos.reset()
            state = {"loss": torch.stack(metric.values), **_module_state(mod)}
            wait0 = telemetry._DATA_WAIT.stats()["sum"]
            ends = []
            t0 = time.perf_counter()
            mod.fit(pipe, begin_epoch=1, num_epoch=2,
                    batch_end_callback=lambda _p: ends.append(time.perf_counter()), **fit)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            wait = telemetry._DATA_WAIT.stats()["sum"] - wait0
    finally:
        chaos.reset()
        pipe.close()
    # a window's callbacks run together at its end: the steps between two
    # window ends, without the epoch's start and end
    windows = sorted(b - a for a, b in zip(ends[DATA_SCAN - 1::DATA_SCAN],
                                           ends[2 * DATA_SCAN - 1::DATA_SCAN]))
    steady_ms = windows[len(windows) // 2] / DATA_SCAN * 1e3 if windows else None
    return mod, state, seconds, wait, launches, rebalances, steady_ms


def run_slice_data(mx, library, Xavier):
    """bench.py's ``_resnet50_symbol(1000)`` at full width, batch 32,
    224x224, fp32, trained by ``Module.fit`` with ``MXNET_SCAN_STEPS=2``
    under cuDNN's deterministic algorithms, fed from ``DATA_RECORDS``
    raw-pixel records written from seed 0 (ImageNet's mean and std) through
    ``RecordFileSource`` -> ``DataPipeline(workers=2)`` -> ``WindowFeed``, 16
    batches an epoch.  Holds: the pipeline's batches with 2 workers, and
    with one reader dying at ``io/reader/read``, are bit-equal to
    ``workers=0``'s; ``RawRecordIter`` unshuffled is bit-equal to the
    source's batches; the state after an epoch (losses, parameters, momenta,
    BatchNorm statistics) with the feed on, and with the failed reader, is
    bit-equal to the feed off.  Prints the step's ms feed on and off (a
    second epoch, the graph captured), ``data_wait_pct``, the numpy reader's
    MB/s and the host ms to stage a window.  The records are deleted
    afterwards.  Returns the kernels' launches (the symbol reaches none)."""
    return _deterministic(_slice_data, mx, library, Xavier)


def _slice_data(mx, library, Xavier):
    from mxnet_tpu_torch import chaos, telemetry
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch", "_build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="slice_data-", dir=root)
    shape = (3, IMAGE, IMAGE)
    try:
        path = os.path.join(tmp, "train.rec")
        t0 = time.perf_counter()
        _write_records(mx, path, DATA_RECORDS)
        write_s = time.perf_counter() - t0
        records = mx.io.RawRecords(path, shape, 1, DATA_MEAN, DATA_STD)
        n_batches = len(records) // BATCH
        t0 = time.perf_counter()
        for i in range(n_batches):
            records.batch(slice(i * BATCH, (i + 1) * BATCH))
        read_s = time.perf_counter() - t0
        read_bytes = records.nbytes(slice(0, n_batches * BATCH))

        def pipeline(workers):
            src = mx.io_pipeline.RecordFileSource(path, shape, BATCH, mean=DATA_MEAN,
                                                  std=DATA_STD)
            return mx.io_pipeline.DataPipeline(src, workers=workers, seed=0)

        failed = []
        serial = _host_batches(pipeline(0))
        d = _batches_differ(_host_batches(pipeline(DATA_WORKERS)), serial)
        if d:
            failed.append(f"workers={DATA_WORKERS}: batches {d[:4]} differ from workers=0")
        rebalances = telemetry._DATA_REBALANCE.value()
        chaos.arm("io/reader/read", "raise", hits=DATA_FAIL_HIT, count=1)
        try:
            d = _batches_differ(_host_batches(pipeline(DATA_WORKERS)), serial)
        finally:
            chaos.reset()
        rebalances = telemetry._DATA_REBALANCE.value() - rebalances
        if d or rebalances != 1:
            failed.append(f"failed reader: batches {d[:4]} differ, {rebalances} rebalances")
        src = mx.io_pipeline.RecordFileSource(path, shape, BATCH, mean=DATA_MEAN, std=DATA_STD)
        in_order = [b for s in range(src.num_shards()) for b in src.read_shard(s)]
        d = _batches_differ(_host_batches(mx.io.RawRecordIter(
            path, shape, BATCH, mean=DATA_MEAN, std=DATA_STD)),
            [(None, b.data[0].asnumpy(), b.label[0].asnumpy()) for b in in_order])
        if d:
            failed.append(f"RawRecordIter: batches {d[:4]} differ from RecordFileSource's")
        stage_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            mx.io.stage_super_batch(in_order[:DATA_SCAN], mx.gpu(0))
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            stage_ms.append((host * 1e3, (time.perf_counter() - t0) * 1e3))
        del serial, in_order

        symbol = _symbol_resnet().resnet50_symbol(mx.sym, num_classes=1000)
        init = mx.mod.Module(symbol, context=mx.gpu(0))
        init.bind(data_shapes=[("data", (BATCH,) + shape)],
                  label_shapes=[("softmax_label", (BATCH, 1))])
        torch.manual_seed(0)
        init.init_params(Xavier())
        params = init.get_params()
        del init
        runs, states, out = {}, {}, {}
        for name, workers, hit in (("feed_on", DATA_WORKERS, None), ("feed_off", 0, None),
                                   ("feed_on_failed_reader", DATA_WORKERS, DATA_FAIL_HIT)):
            mod, state, seconds, wait, launches, reb, steady = _data_fit(
                mx, library, symbol, params, path, workers, hit)
            states[name] = state
            out[name] = {"workers": workers, "losses": state["loss"].tolist(),
                         "step_ms": seconds / n_batches * 1e3, "step_ms_steady": steady,
                         "epoch_seconds": seconds,
                         "data_wait_seconds": wait, "data_wait_pct": wait / seconds * 100,
                         "rebalances": reb, "captures": mod._scan.captures,
                         "windows": mod._scan.windows, "kernel_launches": launches}
            runs[name] = mod
        want = states["feed_off"]
        for name in ("feed_on", "feed_on_failed_reader"):
            differ = _bit_diff(states[name], want)
            out[name]["not_bit_equal_to_feed_off"] = differ[:8]
            if differ:
                failed.append(f"{name}: {len(differ)} tensors differ from feed_off "
                              f"({differ[:4]})")
            if out[name]["windows"] != 2 * n_batches // DATA_SCAN or \
                    out[name]["captures"] != 1:
                failed.append(f"{name}: {out[name]['windows']} windows, "
                              f"{out[name]['captures']} captures")
        if out["feed_on_failed_reader"]["rebalances"] != 1:
            failed.append("the armed reader did not die once")
        finite = all(torch.isfinite(t).all().item() for t in want.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: max(r["kernel_launches"][k] for r in out.values())
                for k in out["feed_on"]["kernel_launches"]}
    on, off = out["feed_on"], out["feed_off"]
    stage_ms.sort()
    emit("slice_data", model="bench.py _resnet50_symbol(1000)", batch=BATCH, image=IMAGE,
         records=DATA_RECORDS, record_bytes=int(records.nbytes(slice(0, 1))),
         batches=n_batches, scan_steps=DATA_SCAN, workers=DATA_WORKERS,
         optimizer={"sgd": MODULE_SGD}, init="Xavier(), seed 0", cudnn_deterministic=True,
         mean=DATA_MEAN, std=DATA_STD, write_seconds=write_s, finite=finite, failed=failed,
         held="batches: workers 2 and a failed reader against workers 0, RawRecordIter "
              "against RecordFileSource; state after an epoch: feed on and a failed reader "
              "against feed off; all bit for bit",
         step_ms_feed_on=on["step_ms"], step_ms_feed_off=off["step_ms"],
         step_ms_steady_feed_on=on["step_ms_steady"],
         step_ms_steady_feed_off=off["step_ms_steady"],
         data_wait_pct=on["data_wait_pct"],
         reader_mb_per_s=read_bytes / read_s / 1e6, reader_seconds_per_batch=read_s / n_batches,
         reader_needed_mb_per_s=read_bytes / n_batches / (on["step_ms"] / 1e3) / 1e6,
         stage_window_host_ms=stage_ms[len(stage_ms) // 2][0],
         stage_window_until_copied_ms=stage_ms[len(stage_ms) // 2][1],
         kernel_launches=launches, **out)
    if failed or not finite:
        raise RuntimeError(f"slice_data: {failed or 'non-finite state'}")
    return launches


def _pipe_mlp(mx):
    """bench.py measure_data_pipeline's MLP: 16 FullyConnected(256) + ReLU,
    then FullyConnected(10) into SoftmaxOutput."""
    h = mx.sym.Variable("data")
    for i in range(PIPE["layers"]):
        h = mx.sym.FullyConnected(h, num_hidden=PIPE["width"], name=f"fc{i}")
        h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=PIPE["classes"], name="fc_out")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def time_data_pipeline(mx, Xavier):
    """bench.py ``measure_data_pipeline`` on the card: the MLP at batch 512,
    K = 8 windows, 16 steps an epoch, from an ``NDArraySource`` through a
    ``DataPipeline`` with ``workers`` 0 (read and staged on the train
    thread) and 2 (two readers and the window feed); after a warm epoch (it
    captures) and a settling one, the median of 3 epochs by wall time.
    Then the same over epochs of ``long_steps`` (``long_epoch``).  Taken
    before the first profiler session; ``profile_data_pipeline`` counts the
    launches later.  Returns the two runners and the readings."""
    from mxnet_tpu_torch import telemetry
    c = PIPE
    rng = np.random.RandomState(0)
    x = rng.randn(c["steps"] * c["batch"], c["features"]).astype(np.float32)
    y = rng.randint(0, c["classes"], c["steps"] * c["batch"]).astype(np.float32)
    fit = {"kvstore": None, "optimizer": "sgd",
           "optimizer_params": {"learning_rate": 0.01, "momentum": 0.9}}
    runners, out = {}, {}
    for name, workers in (("serial", 0), ("pipelined", c["workers"])):
        env = _Env(MXNET_FUSED_STEP=1, MXNET_SCAN_STEPS=c["k"], MXNET_DATA_WORKERS=workers)
        it = mx.io_pipeline.DataPipeline(mx.io_pipeline.NDArraySource(
            x, y, batch_size=c["batch"], batches_per_shard=1), workers=workers, seed=0)
        mod = mx.mod.Module(_pipe_mlp(mx), context=mx.gpu(0))
        with env:
            torch.manual_seed(0)
            mod.fit(it, num_epoch=1, initializer=Xavier(), **fit)
        torch.cuda.synchronize()

        def epoch():
            wait0 = telemetry._DATA_WAIT.stats()["sum"]
            with env:
                t0 = time.perf_counter()
                mod.fit(it, num_epoch=1, **fit)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            return wall / c["steps"] * 1e3, telemetry._DATA_WAIT.stats()["sum"] - wait0, wall

        epoch()
        runs = sorted(epoch() for _ in range(c["epochs"]))
        ms, wait, wall = runs[len(runs) // 2]
        # the same step over epochs of long_steps: the first window's read
        # and stage, which nothing overlaps, weigh 1/16 as much
        it_long = mx.io_pipeline.DataPipeline(mx.io_pipeline.NDArraySource(
            np.tile(x, (c["long_steps"] // c["steps"], 1)),
            np.tile(y, c["long_steps"] // c["steps"]), batch_size=c["batch"],
            batches_per_shard=1), workers=workers, seed=0)
        long_runs = []
        try:
            for _ in range(1 + c["epochs"]):
                wait0 = telemetry._DATA_WAIT.stats()["sum"]
                with env:
                    t0 = time.perf_counter()
                    mod.fit(it_long, num_epoch=1, **fit)
                    torch.cuda.synchronize()
                    wall_long = time.perf_counter() - t0
                long_runs.append((wall_long / c["long_steps"] * 1e3,
                                  (telemetry._DATA_WAIT.stats()["sum"] - wait0) / wall_long * 100))
        finally:
            it_long.close()
        long_ms, long_wait_pct = sorted(long_runs[1:])[len(long_runs[1:]) // 2]
        out[name] = {"workers": workers, "step_ms": ms, "step_ms_runs": [r[0] for r in runs],
                     "data_wait_s_per_epoch": wait, "epoch_seconds": wall,
                     "long_epoch": {"steps": c["long_steps"], "step_ms": long_ms,
                                    "data_wait_pct": long_wait_pct},
                     "windows": mod._scan.windows, "captures": mod._scan.captures}
        runners[name] = (mod, it, env, fit)
    on, off = out["pipelined"], out["serial"]
    return runners, {"k": c["k"], "batch": c["batch"], "steps": c["steps"],
                     "workers": c["workers"], "model": f"MLP {c['layers']} x {c['width']}",
                     "data_wait_pct": on["data_wait_s_per_epoch"] / on["epoch_seconds"] * 100,
                     "serial_ratio": on["step_ms"] / off["step_ms"],
                     "step_ms_pipelined": on["step_ms"], "step_ms_serial": off["step_ms"],
                     "reference_budget_pct": PIPE_REFERENCE_BUDGET_PCT,
                     "reference_budget_note": "the JAX package's own gate, printed beside the "
                                              "result; not a TPU number", **out}


def profile_data_pipeline(runners, out):
    """One more epoch of each side of ``time_data_pipeline`` under
    torch.profiler: the host's kernel and graph launch calls a step and the
    device's kernels a step, which must be equal on both sides (the pipeline
    adds no dispatch).  Emits ``timing_data_pipeline``, then closes the
    pipelines."""
    from torch.profiler import ProfilerActivity, profile
    steps = PIPE["steps"]
    try:
        for name, (mod, it, env, fit) in runners.items():
            torch.cuda.synchronize()
            with env, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                mod.fit(it, num_epoch=1, **fit)
                torch.cuda.synchronize()
            events = prof.key_averages()
            calls = sum(e.count for e in events if e.key in LAUNCH_CALLS)
            kernels = sum(e.count for e in events if e.device_type.name == "CUDA"
                          and not e.key.startswith(("Memcpy", "Memset")))
            out[name]["launch_calls_per_step"] = calls / steps
            out[name]["device_kernels_per_step"] = kernels / steps
    finally:
        for _mod, it, _env, _fit in runners.values():
            it.close()
    on, off = out["pipelined"], out["serial"]
    out["launches_per_step_equal"] = on["launch_calls_per_step"] == off["launch_calls_per_step"]
    emit("timing_data_pipeline", tf32=False, **out)
    if not out["launches_per_step_equal"] or \
            on["device_kernels_per_step"] != off["device_kernels_per_step"]:
        raise RuntimeError(f"timing_data_pipeline: launches a step differ: pipelined "
                           f"{on['launch_calls_per_step']}, {on['device_kernels_per_step']}; "
                           f"serial {off['launch_calls_per_step']}, "
                           f"{off['device_kernels_per_step']}")


# slice_gluon_data and timing_gluon_data: gluon's ResNet-50 v1 (hybridized,
# bf16 AMP, slice_hybridize's form) fed by gluon.data.DataLoader through
# Estimator.fit, exported and imported back as a SymbolBlock
GDATA = {"images": 512, "size": 256, "fit_steps": 4, "workers": 2, "timing_workers": (2, 4),
         "bench_workers": 4}
GDATA_MEAN = (0.485, 0.456, 0.406)     # ImageNet's, as gluon's recipes give them
GDATA_STD = (0.229, 0.224, 0.225)
GDATA_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# the imported forward against the source net's, if the two do not run the
# same kernels: cuDNN's algorithms in strict fp32 part by a few f32 ulps of
# the output's scale
GDATA_EXPORT_REL = 1e-5


def _gdata_dataset(mx):
    """``GDATA["images"]`` uint8 images (256, 256, 3) from seed 0, as one CPU
    NDArray, with the labels ``i % 1000``."""
    rng = np.random.RandomState(0)
    n, size = GDATA["images"], GDATA["size"]
    imgs = rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = (np.arange(n) % 1000).astype(np.float32)
    return mx.gluon.data.ArrayDataset(mx.nd.array(imgs, ctx=mx.cpu(), dtype=np.uint8), labels)


def _gdata_eval_transform(mx):
    T = mx.gluon.data.vision.transforms
    return T.Compose([T.CenterCrop(IMAGE), T.ToTensor(), T.Normalize(GDATA_MEAN, GDATA_STD)])


def _gdata_train_transform(mx):
    T = mx.gluon.data.vision.transforms
    return T.Compose([T.RandomResizedCrop(IMAGE), T.RandomFlipLeftRight(), T.ToTensor(),
                      T.Normalize(GDATA_MEAN, GDATA_STD)])


def _gdata_loader(mx, ds, workers, threads=False, **kw):
    return mx.gluon.data.DataLoader(ds, BATCH, shuffle=True, num_workers=workers,
                                    thread_pool=threads, pin_memory=True, device_prefetch=True,
                                    **kw)


def _shm_entries():
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()


def _pool_snapshot():
    import multiprocessing
    import threading
    return {"shm": _shm_entries(), "children": set(multiprocessing.active_children()),
            "threads": set(threading.enumerate())}


def _pool_left(snap):
    """What was started after ``snap`` and is still there: child processes,
    ``mx-*`` threads (each given 10 s to end) and ``/dev/shm`` entries."""
    import multiprocessing
    import threading
    threads = [t for t in threading.enumerate()
               if t not in snap["threads"] and t.name.startswith("mx-")]
    for t in threads:
        t.join(timeout=10)
    return {"children": [p.name for p in multiprocessing.active_children()
                         if p not in snap["children"]],
            "threads": [t.name for t in threads if t.is_alive()],
            "shm": sorted(_shm_entries() - snap["shm"])}


def _device_epoch(loader, seed):
    """One epoch of ``loader`` after ``np.random.seed(seed)``: its batches'
    (data, label) tensors, on the card."""
    np.random.seed(seed)
    return [(x._data, y._data) for x, y in loader]


def _gdata_state(net, trainer):
    """Every parameter, aux state and momentum of a gluon run, copied, by
    name less the net's prefix."""
    cut = len(net.prefix)
    out = {}
    for name, p in net.collect_params().items():
        out[f"{'aux' if p.is_aux else 'param'}:{name[cut:]}"] = p._tensor().detach().clone()
    for i, state in trainer._updaters[0].states.items():
        out[f"mom:{trainer._params[i].name[cut:]}"] = state._data.clone()
    return out


def _gdata_net(mx, vision, path):
    net = vision.resnet50_v1()
    net.load_parameters(path, ctx=mx.gpu(0))
    net.hybridize()
    return net, mx.gluon.Trainer(net.collect_params(), "sgd", GDATA_SGD)


def _gdata_launches(library, rtc):
    torch.cuda.synchronize()
    return {**{k: v.launches for k, v in library.KERNELS.items()}, "rtc": rtc.launches}


def run_slice_gluon_data(mx, vision, Xavier, library, rtc):
    """gluon's input and its way back in, under cuDNN's deterministic
    algorithms: ``resnet50_v1()`` at full width (Xavier, seed 0), hybridized,
    bf16 AMP, ``Trainer('sgd', GDATA_SGD)``, ``SoftmaxCrossEntropyLoss``,
    fed from ``GDATA["images"]`` uint8 images (256, 256, 3) of seed 0 through
    ``gluon.data.DataLoader`` (batch 32, shuffled, ``pin_memory`` and
    ``device_prefetch``).  Holds: with CenterCrop(224), ToTensor and
    Normalize, one epoch's batches with 2 worker processes and with 2 worker
    threads equal ``num_workers=0``'s bit for bit; ``GDATA["fit_steps"]``
    steps of ``Estimator.fit`` fed by the 2-process loader equal a
    hand-written ``record``/``backward``/``step`` loop fed by the serial
    loader bit for bit (parameters, momenta, BatchNorm statistics, the
    loss and accuracy metrics); the trained net exported and loaded back by
    ``SymbolBlock.imports(ctx=gpu(0))`` computes the net's fp32 predict
    forward on a batch (bit for bit, else within ``GDATA_EXPORT_REL``);
    each loader worker reports no ``jax``, no ``mxnet_tpu`` and no CUDA
    context; the phase leaves no child process, ``mx-*`` thread or
    ``/dev/shm`` entry.  The kernels' launches in ``Estimator.fit`` are
    counted (the path reaches none of them).  Returns (launches, the
    dataset, the hand loop's net and trainer, for ``timing_gluon_data``)."""
    return _deterministic(_slice_gluon_data, mx, vision, Xavier, library, rtc)


def _slice_gluon_data(mx, vision, Xavier, library, rtc):
    WorkerReport = _test_helper("torch_gluon_data_helper").WorkerReport
    snap = _pool_snapshot()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch", "_build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="slice_gluon_data-", dir=root)
    failed, out = [], {}
    try:
        t0 = time.perf_counter()
        ds = _gdata_dataset(mx)
        out["dataset_seconds"] = time.perf_counter() - t0
        evald = ds.transform_first(_gdata_eval_transform(mx))
        epochs = {}
        for name, workers, threads in (("serial", 0, False), ("processes", GDATA["workers"], False),
                                       ("threads", GDATA["workers"], True)):
            loader = _gdata_loader(mx, evald, workers, threads)
            try:
                t0 = time.perf_counter()
                epochs[name] = _device_epoch(loader, 0)
                torch.cuda.synchronize()
                out[f"epoch_seconds_{name}"] = time.perf_counter() - t0
            finally:
                loader.close()
        want = epochs["serial"]
        b0 = want[0][0]
        out["loader_batch"] = {"shape": list(b0.shape), "dtype": str(b0.dtype),
                               "device": str(b0.device), "batches": len(want)}
        if b0.device.type != "cuda" or b0.dtype != torch.float32 or \
                len(want) != GDATA["images"] // BATCH:
            failed.append(f"serial batches: {out['loader_batch']}")
        for name in ("processes", "threads"):
            differ = [i for i, ((gx, gy), (wx, wy)) in enumerate(zip(epochs[name], want))
                      if not (torch.equal(gx, wx) and torch.equal(gy, wy))]
            out[f"batches_not_bit_equal_{name}"] = differ
            if differ or len(epochs[name]) != len(want):
                failed.append(f"{name}: batches {differ[:4]} differ from num_workers=0's")
        x_export = want[0][0]
        del epochs

        path = os.path.join(tmp, "resnet50_v1.params")
        src = vision.resnet50_v1()
        src.initialize(Xavier(), ctx=mx.gpu(0), generator=torch.Generator().manual_seed(0))
        with mx.autograd.pause():
            src(mx.nd.zeros((1, 3, IMAGE, IMAGE), ctx=mx.gpu(0)))
        src.save_parameters(path)
        del src
        fit_ds = ds.take(GDATA["fit_steps"] * BATCH).transform_first(_gdata_eval_transform(mx))

        # Estimator.fit fed by the 2-process loader
        est_net, est_trainer = _gdata_net(mx, vision, path)
        est = mx.gluon.contrib.estimator.Estimator(
            est_net, loss=mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            metrics=mx.metric.Accuracy(), trainer=est_trainer)
        loader = _gdata_loader(mx, fit_ds, GDATA["workers"])
        try:
            np.random.seed(1)
            mx.amp.init(target_dtype="bfloat16")
            torch.cuda.synchronize()
            library.reset_launches()
            t0 = time.perf_counter()
            est.fit(loader, epochs=1)
            launches = _gdata_launches(library, rtc)
            out["fit_seconds"] = time.perf_counter() - t0
        finally:
            mx.amp.deinit()
            loader.close()
        got, got_metrics = _gdata_state(est_net, est_trainer), est.metric_values()

        # the same steps by hand, fed by the serial loader
        net, trainer = _gdata_net(mx, vision, path)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        loss_metric, acc = mx.metric.Loss(name="loss"), mx.metric.Accuracy()
        loader = _gdata_loader(mx, fit_ds, 0)
        try:
            np.random.seed(1)
            mx.amp.init(target_dtype="bfloat16")
            steps = 0
            for x, y in loader:
                with mx.autograd.record():
                    pred = net(x)
                    loss = loss_fn(pred, y)
                loss.backward()
                trainer.step(x.shape[0])
                loss_metric.update(None, [loss])
                acc.update([y], [pred])
                steps += 1
            torch.cuda.synchronize()
        finally:
            mx.amp.deinit()
            loader.close()
        want_state = _gdata_state(net, trainer)
        want_metrics = {**dict([acc.get()]), **dict([loss_metric.get()])}
        differ = _bit_diff(got, want_state)
        out["fit"] = {"steps": steps, "tensors": len(want_state), "not_bit_equal": differ[:8],
                      "metrics": got_metrics, "hand_loop_metrics": want_metrics,
                      "captures": len(est_net._cached), "hand_loop_captures": len(net._cached),
                      "kernel_launches": launches}
        if differ or got_metrics != want_metrics or steps != GDATA["fit_steps"]:
            failed.append(f"Estimator.fit: {len(differ)} tensors differ from the hand loop "
                          f"({differ[:4]}), metrics {got_metrics} vs {want_metrics}, "
                          f"{steps} steps")
        finite = all(torch.isfinite(t).all().item() for t in want_state.values())
        del got, want_state

        # export, and back in through SymbolBlock.imports
        prefix = os.path.join(tmp, "resnet50_v1")
        est_net.export(prefix)
        sb = mx.gluon.SymbolBlock.imports(f"{prefix}-symbol.json", ["data"],
                                          f"{prefix}-0000.params", ctx=mx.gpu(0))
        xe = mx.nd.NDArray(x_export)
        ref = est_net(xe)._data
        imported = sb(xe)._data
        torch.cuda.synchronize()
        err = (imported - ref).abs().max().item()
        scale = ref.abs().max().item()
        out["export"] = {"files": sorted(os.listdir(tmp)), "bit_equal": torch.equal(imported, ref),
                         "max_abs_err": err, "rel_err": err / scale, "output_scale": scale,
                         "shape": list(imported.shape), "parameters": len(sb.collect_params()),
                         "aux_null_grad": sum(p.grad_req == "null"
                                              for p in sb.collect_params().values())}
        if not out["export"]["bit_equal"] and err > GDATA_EXPORT_REL * scale:
            failed.append(f"SymbolBlock.imports forward: max |err| {err} of scale {scale}")

        # what each loader worker holds
        loader = mx.gluon.data.DataLoader(WorkerReport(8), 2, num_workers=GDATA["workers"])
        try:
            with mx.cpu():
                rows = np.concatenate([b.asnumpy() for b in loader])
        finally:
            loader.close()
        out["workers"] = {"pids": sorted(set(rows[:, 0].tolist())), "main_pid": os.getpid(),
                          "jax_in_sys_modules": rows[:, 1].astype(bool).tolist(),
                          "mxnet_tpu_in_sys_modules": rows[:, 2].astype(bool).tolist(),
                          "cuda_initialized": rows[:, 3].astype(bool).tolist(),
                          "default_context_cpu": rows[:, 4].astype(bool).tolist(),
                          "start_method": mx.config.mp_start_method()}
        if rows[:, 1:4].any() or not rows[:, 4].all() or os.getpid() in rows[:, 0] or \
                len(set(rows[:, 0].tolist())) != GDATA["workers"]:
            failed.append(f"loader workers: {out['workers']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    left = _pool_left(snap)
    if any(left.values()):
        failed.append(f"left behind: {left}")
    emit("slice_gluon_data", model="resnet50_v1 (deferred shapes), hybridized, bf16 AMP",
         batch=BATCH, image=IMAGE, images=GDATA["images"], source_size=GDATA["size"],
         optimizer={"sgd": GDATA_SGD}, init="Xavier(), seed 0", cudnn_deterministic=True,
         mp_start_method=mx.config.mp_start_method(), cpu_count=os.cpu_count(),
         held="one epoch's batches: 2 processes and 2 threads against num_workers=0; "
              "Estimator.fit (2 processes) against a hand loop (serial loader); all bit for "
              "bit; the SymbolBlock.imports forward against the net's",
         finite=finite, left_behind=left, failed=failed, **out)
    if failed or not finite:
        raise RuntimeError(f"slice_gluon_data: {failed or 'non-finite state'}")
    return launches, ds, net, trainer


class _TimedIter:
    """Iterates ``loader``, adding the time blocked in each ``next`` to
    ``wait``."""

    def __init__(self, loader):
        self.loader, self.wait = loader, 0.0

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.wait += time.perf_counter() - t0
            yield batch


def _gdata_step(mx, net, trainer):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(x, y):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(BATCH)

    return step


def _timed_epoch(mx, step, batches):
    """One bf16 epoch of ``step`` over ``batches`` (an iterable): (seconds,
    seconds blocked in ``next``, steps)."""
    timed = _TimedIter(batches)
    mx.amp.init(target_dtype="bfloat16")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for x, y in timed:
            step(x, y)
            n += 1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        mx.amp.deinit()
    return seconds, timed.wait, n


def time_gluon_data(mx, ds, net, trainer):
    """gluon's ImageNet recipe, its random half (RandomResizedCrop(224),
    RandomFlipLeftRight, ToTensor, Normalize), over ``slice_gluon_data``'s
    images, shuffled, ``last_batch='discard'``, 16 steps an epoch, feeding
    its hybridized bf16 ResNet-50 step; each time is epoch 2's, taken
    before the process's first profiler session: ms a step and
    ``data_wait_pct`` (the train thread's time blocked in the loader's
    ``next`` over the epoch's wall time) at 2 and 4 worker processes, with
    the same epoch's batches held on the card beforehand, and under
    ``Estimator.fit`` at 2 workers; the host ms an image of each transform
    on one torch thread; ``dataloader_img_per_sec``, the second stage of
    ``tools/bench_pipeline.py`` (float32 (512, 3, 224, 224), batch 32, 4
    workers, ``device_prefetch``), and the same with no worker.  Closes
    its loaders and gives the net's captured graphs back, since later
    phases time the host.  Returns the readings and what
    ``profile_gluon_data`` needs."""
    snap = _pool_snapshot()
    recipe = ds.transform_first(_gdata_train_transform(mx))
    step = _gdata_step(mx, net, trainer)
    out = {"cpu_count": os.cpu_count(), "steps_per_epoch": GDATA["images"] // BATCH,
           "mp_start_method": mx.config.mp_start_method(), "configs": {}}
    loaders = {}
    try:
        for workers in GDATA["timing_workers"]:
            loader = _gdata_loader(mx, recipe, workers, last_batch="discard")
            loaders[workers] = loader
            _timed_epoch(mx, step, loader)
            seconds, wait, n = _timed_epoch(mx, step, loader)
            out["configs"][f"workers_{workers}"] = {
                "step_ms": seconds / n * 1e3, "img_per_s": n * BATCH / seconds,
                "data_wait_pct": wait / seconds * 100, "epoch_seconds": seconds, "steps": n}
        np.random.seed(2)
        held = [(x, y) for x, y in loaders[max(GDATA["timing_workers"])]]
        _timed_epoch(mx, step, held)
        seconds, wait, n = _timed_epoch(mx, step, held)
        out["configs"]["batches_on_device"] = {"step_ms": seconds / n * 1e3,
                                               "img_per_s": n * BATCH / seconds,
                                               "data_wait_pct": wait / seconds * 100,
                                               "steps": n}
        del held
        est = mx.gluon.contrib.estimator.Estimator(
            net, loss=mx.gluon.loss.SoftmaxCrossEntropyLoss(), metrics=mx.metric.Accuracy(),
            trainer=trainer)
        timed = _TimedIter(loaders[GDATA["workers"]])
        mx.amp.init(target_dtype="bfloat16")
        try:
            est.fit(timed, epochs=1)
            timed.wait = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.fit(timed, epochs=1)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            mx.amp.deinit()
        out["configs"]["estimator_workers_2"] = {
            "step_ms": seconds / out["steps_per_epoch"] * 1e3,
            "img_per_s": GDATA["images"] // BATCH * BATCH / seconds,
            "data_wait_pct": timed.wait / seconds * 100}
    finally:
        for loader in loaders.values():
            loader.close()
    out["augment_ms_per_image_one_thread"] = {
        "eval": _augment_ms(ds.transform_first(_gdata_eval_transform(mx))),
        "recipe": _augment_ms(recipe)}
    out["dataloader_img_per_sec"] = _bench_pipeline_stage(mx, GDATA["bench_workers"])
    out["dataloader_img_per_sec_serial"] = _bench_pipeline_stage(mx, 0)
    # the phases after this one time the host: give the card's memory back
    # (the net's captured graphs) and leave no worker running
    net._clear_cached_op()
    gc.collect()
    torch.cuda.empty_cache()
    return out, (mx, recipe, step, snap)


def _augment_ms(ds, n=64):
    """The host ms to make one sample of ``ds`` (its transform included) on
    one torch thread, the way a worker process makes it: the median of 3
    passes over ``n`` samples."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from mxnet_tpu_torch.context import cpu
        times = []
        with cpu():
            for _ in range(3):
                t0 = time.perf_counter()
                for i in range(n):
                    ds[i]
                times.append((time.perf_counter() - t0) / n * 1e3)
    finally:
        torch.set_num_threads(saved)
    return sorted(times)[1]


def _bench_pipeline_stage(mx, workers):
    """``tools/bench_pipeline.py``'s DataLoader stage: float32 (512, 3, 224,
    224) from seed 0 with labels ``i % 10``, batch 32, ``workers`` workers
    (0: the train thread reads and stacks), ``device_prefetch``; 2 batches
    to warm, then one epoch timed until its last copy is done."""
    rng = np.random.RandomState(0)
    n = GDATA["images"]
    data = rng.randn(n, 3, IMAGE, IMAGE).astype(np.float32)
    label = (np.arange(n) % 10).astype(np.float32)
    loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(data, label), BATCH,
                                      num_workers=workers, device_prefetch=True)
    try:
        for _ in zip(range(2), loader):
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen = 0
        for d, _l in loader:
            seen += d.shape[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    return {"value": seen / dt, "unit": "img/s", "images": seen, "batch": BATCH,
            "workers": workers, "device_prefetch": True,
            "mb_per_s": seen * 3 * IMAGE * IMAGE * 4 / dt / 1e6}


def profile_gluon_data(runner, out):
    """One loader epoch (2 workers) of ``time_gluon_data``'s step under
    torch.profiler, after an unprofiled one that captures the step again:
    the device's idle share over it.  Then closes the loader, checks that
    nothing the timing started is left, and emits ``timing_gluon_data``."""
    mx, recipe, step, snap = runner
    loader = _gdata_loader(mx, recipe, GDATA["workers"], last_batch="discard")
    try:
        _timed_epoch(mx, step, loader)

        def epoch():
            _timed_epoch(mx, step, loader)
        prof = step_breakdown(epoch, iters=1)
    finally:
        loader.close()
    steps = out["steps_per_epoch"]
    out["profiled_epoch"] = {
        "steps": steps, "wall_ms_per_step": prof["wall_ms_per_step"] / steps,
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"] / steps,
        "device_idle_share": prof["device_idle_share"],
        "top_kernels": [{**k, "ms_per_step": k["ms_per_step"] / steps,
                         "calls_per_step": k["calls_per_step"] / steps}
                        for k in prof["top_kernels"][:6]]}
    left = _pool_left(snap)
    emit("timing_gluon_data", tf32=False, left_behind=left, **out)
    if any(left.values()):
        raise RuntimeError(f"timing_gluon_data: left behind {left}")


# slice_spmd, slice_spmd_ranks and slice_kvstore: data parallelism.  gluon's
# ResNet-50 v1 at full width (batch 32, 224x224, Xavier on seed 0, deferred
# shapes), SGD with momentum, fp32, trained by parallel.spmd.TrainStep on a
# one-rank mesh, held to the gluon Trainer step from the same .params file
# under cuDNN's deterministic algorithms: bit for bit where the two run the
# same kernels (every tensor after each step), else by slice_gluon's fp32
# bounds (``_hold_gluon`` on the first two steps).  Then the same net and
# batch on SPMD_RANKS processes sharing the card, dp = 2 x 16 rows over gloo
# (NCCL refuses two ranks on one device): BatchNorm's statistics and the
# gradients are all-reduced through host memory.  Held to the one-rank step
# by the parity rule for deep nets (ROADMAP): the rows reduce in other
# orders, the batch statistics come from another formula, cuDNN picks its
# algorithms for 16 rows, and a ReLU kink crossed by rounding moves a
# gradient by a whole term.  Such partings grow from step to step (PERF.md
# §6), so each step is held from the one-rank step's own starting point:
# step 1 from the file's weights, step 2 after the ranks load the one-rank
# step's whole state after step 1 (``TrainStep.load_state_dict``).  Each
# step: the loss within SPMD_RANKS_LOSS_REL, each trainable tensor's update
# (w_after - w_before) in the 2-norm within SPMD_RANKS_UPDATE_REL of its
# own (of the group's for a zero-gradient bias, ZERO_GRAD_TENSOR).  The
# ranks' tensors bit-equal.
SPMD_STEPS = 3
SPMD_RANKS, SPMD_RANK_STEPS = 2, 2
SPMD_TIMED_STEPS = 3
SPMD_SGD = {"learning_rate": SGD["lr"], "momentum": SGD["momentum"], "wd": SGD["wd"]}
SPMD_RANKS_LOSS_REL = 1e-5
SPMD_RANKS_UPDATE_REL = 0.1
SPMD_RANKS_TIMEOUT_S = 600
# slice_kvstore: ResNet-50's 193 trainable tensors as keys, two gradient
# copies a key on gpu(0), SGD with momentum in the store
KV_THRESHOLD = 0.5
KV_TIMED_ROUNDS = 5


def _spmd_batch():
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    return x, y.float()


def _spmd_state(step, net, losses):
    """A TrainStep's whole state keyed as ``_gluon_state`` keys a gluon
    run's (``param:``, ``aux:``, ``mom:``; names less the net's prefix)."""
    cut = len(net.prefix)
    aux = {n for n, p in net.collect_params().items() if p.is_aux}
    out = {"loss": torch.stack([torch.as_tensor(v, device="cuda").float().reshape(())
                                for v in losses])}
    for key, t in step.state_dict().items():
        kind, name = key.split(":", 1)
        if kind == "opt":
            out[f"mom:{name.rsplit(':', 1)[0][cut:]}"] = t.clone()
        else:
            out[f"{'aux' if name in aux else 'param'}:{name[cut:]}"] = t.clone()
    return out


def _state_names(state, old, new):
    """A TrainStep state dict (``kind:name``) on the host, each name's
    prefix ``old`` replaced by ``new``: nets made in other processes are
    numbered apart."""
    out = {}
    for key, t in state.items():
        kind, name = key.split(":", 1)
        if not name.startswith(old):
            raise RuntimeError(f"state tensor {key!r} lacks the prefix {old!r}")
        out[f"{kind}:{new}{name[len(old):]}"] = t.detach().to("cpu", copy=True)
    return out


def _bit_equal_states(got, want):
    """The keys of ``want`` whose tensors differ from ``got``'s (the losses
    included)."""
    return [k for k in want if not torch.equal(got[k], want[k])]


def run_slice_spmd(mx, vision, Xavier, library):
    """``SPMD_STEPS`` TrainStep steps on a one-rank mesh, held to the gluon
    step; returns the timed step functions, the launch counts of the
    steps' run, and what ``slice_spmd_ranks`` and ``slice_kvstore`` need."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _slice_spmd(mx, vision, Xavier, library)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _slice_spmd(mx, vision, Xavier, library):
    from mxnet_tpu_torch import parallel, rtc
    gpu = mx.gpu(0)
    src = vision.resnet50_v1()
    src.initialize(Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(0))
    x, y = _spmd_batch()
    with mx.autograd.pause():
        src(mx.nd.from_dlpack(x[:1].clone()))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                        "_build", "slice_spmd.params")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    src.save_parameters(path)
    cut = len(src.prefix)
    w0 = _groups({f"param:{n[cut:]}": p._tensor() for n, p in src.collect_params().items()
                  if not p.is_aux})["param"]
    del src

    net = vision.resnet50_v1()
    net.load_parameters(path, ctx=gpu)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = parallel.TrainStep(net, loss_fn, "sgd", dict(SPMD_SGD), parallel.make_mesh(dp=1),
                              (x, y))
    torch.cuda.synchronize()
    library.reset_launches()
    got, losses = [], []
    t0 = time.perf_counter()
    for i in range(SPMD_STEPS):
        losses.append(step(x, y))
        got.append(_spmd_state(step, net, losses))
        if i == 0:
            after_step1 = _state_names(step.state_dict(), net.prefix, "")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**{name: k.launches for name, k in library.KERNELS.items()},
                "rtc": rtc.launches}
    if any(launches.values()):
        raise RuntimeError(f"slice_spmd: a kernel launched: {launches}")

    gnet = vision.resnet50_v1()
    gnet.load_parameters(path, ctx=gpu)
    trainer = mx.gluon.Trainer(gnet.collect_params(), "sgd", dict(SPMD_SGD))
    xn, yn = mx.nd.from_dlpack(x), mx.nd.from_dlpack(y)

    def gluon_step():
        with mx.autograd.record():
            loss = loss_fn(gnet(xn), yn)
        loss.backward()
        trainer.step(BATCH)
        return loss

    want, glosses = [], []
    for _ in range(SPMD_STEPS):
        glosses.append(gluon_step())
        want.append(_gluon_state(gnet, trainer, glosses))
    if sorted(got[-1]) != sorted(want[-1]):
        raise RuntimeError(f"slice_spmd: the states' tensors differ: "
                           f"{sorted(set(got[-1]) ^ set(want[-1]))[:4]}")
    differ = [_bit_equal_states(g, w) for g, w in zip(got, want)]
    readings, failed = {"bit_equal_steps": [not d for d in differ],
                        "differing_tensors": [len(d) for d in differ]}, []
    if any(differ):
        held, failed = _hold_gluon(got[:2], want[:2], w0, "float32")
        params = [k for k in want[2] if k.startswith("param:")]
        step3 = _group_rel_err({k: got[2][k] - got[1][k] for k in params},
                               {k: want[2][k] - want[1][k] for k in params})
        if step3 > GLUON_F32_STEP2_REL:
            failed.append("step 3 update")
        readings.update(held, step3_update_rel_err_2norm=step3)
    finite = all(torch.isfinite(t).all().item() for t in got[-1].values())
    out = {"seconds": seconds, "losses": got[-1]["loss"].tolist(),
           "gluon_losses": want[-1]["loss"].tolist(), "launches": launches, "finite": finite,
           **readings}
    if failed or not finite:
        emit("slice_spmd", failed=failed, **out)
        raise RuntimeError(f"slice_spmd: {len(failed)} checks past their bounds: {failed[:8]}")
    emit("slice_spmd", model="resnet50_v1 (deferred shapes)", batch=BATCH, image=IMAGE,
         classes=1000, steps=SPMD_STEPS, mesh={"dp": 1}, optimizer={"sgd": SPMD_SGD},
         cudnn_deterministic=True, tf32=False,
         held_to="gluon Trainer('sgd') step from the same .params file",
         tolerance="bit for bit" if not any(differ) else
         {"fallback": "slice_gluon's fp32 bounds", "step3_update_2norm": GLUON_F32_STEP2_REL},
         **out)
    # step 2 of slice_spmd_ranks starts from the one-rank step's state
    step1_path = os.path.join(os.path.dirname(path), "slice_spmd_step1.pt")
    torch.save(after_step1, step1_path)
    return {"spmd_fp32": lambda: step(x, y), "spmd_gluon_fp32": gluon_step}, launches, \
        {"path": path, "step1_path": step1_path,
         "states": [{k: v.cpu() for k, v in s.items()} for s in got[:SPMD_RANK_STEPS]],
         "w0": {k: v.cpu() for k, v in w0.items()}}


def _spmd_rank(rank, world, workdir, params_path, step1_path, steps, timed_steps):
    """One rank of ``slice_spmd_ranks`` (a spawned process): TrainStep on a
    dp mesh of ``world`` gloo ranks on ``cuda:0``, its first step from
    ``params_path`` and each later one from the one-rank step's state after
    step 1 (``step1_path``); saves its losses, its state after each step
    and its timings to ``workdir``."""
    import datetime

    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SPMD_RANKS_TIMEOUT_S))
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import parallel
        from mxnet_tpu_torch.gluon.model_zoo import vision
        x, y = _spmd_batch()
        net = vision.resnet50_v1()
        net.load_parameters(params_path, ctx=mx.gpu(0))
        step = parallel.TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                                  dict(SPMD_SGD), parallel.make_mesh(dp=world), (x, y))
        from mxnet_tpu_torch import rtc
        from mxnet_tpu_torch.kernels import library
        library.reset_launches()
        after_step1 = _state_names(torch.load(step1_path, weights_only=True), "", net.prefix)
        losses, states = [], []
        for i in range(steps):
            if i == 1:
                step.load_state_dict(after_step1)
            losses.append(step(x, y))
            states.append({k: v.cpu() for k, v in _spmd_state(step, net, losses).items()})
        torch.cuda.synchronize()
        launches = {**{name: k.launches for name, k in library.KERNELS.items()},
                    "rtc": rtc.launches}
        state = states[-1]
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            step(x, y)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
        # the collectives' share: each collective between synchronizations
        spent = {"all_reduce_s": 0.0, "calls": 0}
        real = dist.all_reduce

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            spent["all_reduce_s"] += time.perf_counter() - c0
            spent["calls"] += 1
            return out

        dist.all_reduce = timed
        try:
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(timed_steps):
                step(x, y)
            torch.cuda.synchronize()
            instrumented_s = time.perf_counter() - t0
        finally:
            dist.all_reduce = real
        torch.save({"losses": [float(v) for v in losses], "state": state, "states": states,
                    "step_ms": step_ms,
                    "instrumented_step_ms": instrumented_s / timed_steps * 1e3,
                    "collective_ms_per_step": spent["all_reduce_s"] / timed_steps * 1e3,
                    "collective_calls_per_step": spent["calls"] / timed_steps,
                    "rows": BATCH // world, "launches": launches},
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spmd_parting(got, want, w0):
    """How far the state ``got`` parts from ``want``, both one step from
    the state ``w0``: the last loss's relative error, each trainable
    tensor's update error in the 2-norm over its update's (over the group's
    for a zero-gradient bias), and the group's."""
    params = [k for k in want if k.startswith("param:")]
    ups_g = {k: got[k].double() - w0[k].double() for k in params}
    ups_w = {k: want[k].double() - w0[k].double() for k in params}
    group = math.sqrt(sum((u ** 2).sum().item() for u in ups_w.values()))
    per = {}
    for k in params:
        norm = ups_w[k].norm().item()
        if ZERO_GRAD_TENSOR.match(k) or norm == 0.0:
            norm = group
        per[k] = (ups_g[k] - ups_w[k]).norm().item() / norm
    loss_g, loss_w = got["loss"][-1].double().item(), want["loss"][-1].double().item()
    return {"loss_rel": abs(loss_g - loss_w) / abs(loss_w), "per_tensor": per,
            "update_group": _group_rel_err(ups_g, ups_w)}


def run_slice_spmd_ranks(spmd):
    """``slice_spmd``'s net and batch on ``SPMD_RANKS`` spawned processes
    sharing the card, dp over gloo; held to the one-rank step."""
    import multiprocessing

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch", "_build")
    workdir = tempfile.mkdtemp(prefix="spmd_ranks_", dir=build)
    snap = _pool_snapshot()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spmd_rank, name=f"spmd-rank{r}",
                         args=(r, SPMD_RANKS, workdir, spmd["path"], spmd["step1_path"],
                               SPMD_RANK_STEPS, SPMD_TIMED_STEPS))
             for r in range(SPMD_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPMD_RANKS_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if codes != [0] * SPMD_RANKS:
            raise RuntimeError(f"slice_spmd_ranks: rank exit codes {codes}")
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(SPMD_RANKS)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    left = _pool_left(snap)
    if any(left.values()):
        raise RuntimeError(f"slice_spmd_ranks: left behind {left}")
    w0, failed = spmd["w0"], []
    for r, res in enumerate(ranks[1:], 1):
        differ = _bit_equal_states(res["state"], ranks[0]["state"])
        if differ:
            failed.append(f"rank {r} differs from rank 0 in {len(differ)} tensors: "
                          f"{differ[:3]}")
    launches = {name: sum(r["launches"][name] for r in ranks) for name in ranks[0]["launches"]}
    if any(launches.values()):
        failed.append(f"a kernel launched: {launches}")
    readings = {"losses": [r["losses"] for r in ranks],
                "one_rank_losses": spmd["states"][-1]["loss"].tolist(), "steps": []}
    starts = [w0] + spmd["states"][:-1]
    for i, (got, want, start) in enumerate(zip(ranks[0]["states"], spmd["states"], starts)):
        part = _spmd_parting(got, want, start)
        if part["loss_rel"] > SPMD_RANKS_LOSS_REL:
            failed.append(f"step {i + 1} loss")
        per = part.pop("per_tensor")
        failed += [f"step {i + 1} update {k}" for k, e in per.items()
                   if e > SPMD_RANKS_UPDATE_REL]
        worst = max(per, key=per.get)
        part["update_worst"] = {"tensor": worst, "rel_err_2norm": per[worst]}
        part["update_median"] = sorted(per.values())[len(per) // 2]
        readings["steps"].append(part)
    timing = {"step_ms_per_rank": [r["step_ms"] for r in ranks],
              "instrumented_step_ms_per_rank": [r["instrumented_step_ms"] for r in ranks],
              "collective_ms_per_step_per_rank": [r["collective_ms_per_step"] for r in ranks],
              "collective_calls_per_step": ranks[0]["collective_calls_per_step"],
              "collective_share": [r["collective_ms_per_step"] / r["instrumented_step_ms"]
                                   for r in ranks],
              "img_per_s": BATCH / max(r["step_ms"] for r in ranks) * 1e3,
              "launches": launches,
              "label": ("gloo all-reduce through host memory, two processes on one card: "
                        "not a figure for NCCL or for several cards")}
    if failed:
        emit("slice_spmd_ranks", failed=failed, **readings, timing=timing)
        raise RuntimeError(f"slice_spmd_ranks: {len(failed)} checks past their bounds: "
                           f"{failed[:8]}")
    emit("slice_spmd_ranks", model="resnet50_v1", ranks=SPMD_RANKS, backend="gloo",
         mesh={"dp": SPMD_RANKS}, rows_per_rank=ranks[0]["rows"], n_steps=SPMD_RANK_STEPS,
         seconds=seconds, start_method="spawn", left_behind=left, tf32=False,
         cudnn_deterministic=True, launches=launches,
         held_to=f"slice_spmd's one-rank step at {BATCH} rows",
         tolerance={"loss_rel": SPMD_RANKS_LOSS_REL,
                    "update_2norm_rel_each_tensor": SPMD_RANKS_UPDATE_REL,
                    "start_of_each_step": "the one-rank step's state before it",
                    "ranks": "bit for bit"}, **readings, timing=timing)
    return timing, launches


def run_slice_kvstore(mx, vision, Xavier, library, multi_sgd_mom_update, spmd):
    """ResNet-50's trainable tensors in a ``'device'`` and an ``'ici'``
    store: two gradient copies a key on gpu(0) pushed with SGD momentum in
    the store, then pulled, bit-equal to ``multi_sgd_mom_update`` on the
    summed gradients; push + pull timed by CUDA events.  A compressed
    ``'device'`` store (the 2-bit codec on the card, over the whole
    gradient) against the numpy codec on the host copies: the pulled sums
    and the residuals bit for bit.  ``Trainer(kvstore='device')`` over one
    context against ``kvstore=None``."""
    from mxnet_tpu_torch import gradient_compression as gc
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ndarray import NDArray
    net = resnet50(vision, Xavier, 0)
    net.to("cuda")
    weights = [p._tensor().detach() for p in net.collect_params().values()
               if p._tensor().requires_grad]
    if sum(w.numel() for w in weights) != RESNET50_TRAINABLE:
        raise RuntimeError("resnet50_v1's trainable tensors changed")
    gen = torch.Generator(device="cuda").manual_seed(12)
    copies = [[torch.randn(w.shape, generator=gen, device="cuda") for w in weights]
              for _ in range(2)]
    keys = list(range(len(weights)))
    out, timing = {}, {}
    torch.cuda.synchronize()
    library.reset_launches()
    for name in ("device", "ici"):
        kv = mx.kv.create(name)
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=SGD["lr"],
                                             momentum=SGD["momentum"], wd=SGD["wd"]))
        kv.init(keys, [NDArray(w.clone()) for w in weights])
        outs = [NDArray(torch.zeros_like(w)) for w in weights]
        grads = [[NDArray(c[i]) for c in copies] for i in keys]
        kv.push(keys, grads)
        kv.pull(keys, out=outs)
        torch.cuda.synchronize()
        ref = [w.clone() for w in weights]
        moms = [torch.zeros_like(w) for w in weights]
        multi_sgd_mom_update(ref, [a + b for a, b in zip(*copies)], moms, lrs=SGD["lr"],
                             wds=SGD["wd"], momentum=SGD["momentum"], rescale_grad=1.0)
        differ = [i for i in keys if not torch.equal(outs[i]._data, ref[i])]
        if differ:
            raise RuntimeError(f"slice_kvstore {name}: {len(differ)} pulled weights differ "
                               f"from multi_sgd_mom_update on the summed gradients")
        states = kv._updater.states
        if any(not torch.equal(states[i]._data, moms[i]) for i in keys):
            raise RuntimeError(f"slice_kvstore {name}: the store's momenta differ")

        def round_trip(kv=kv, grads=grads, outs=outs):
            kv.push(keys, grads)
            kv.pull(keys, out=outs)

        timing[name] = {"push_pull_ms": cuda_ms(round_trip, iters=KV_TIMED_ROUNDS, warmup=1)}
        out[name] = {"keys": len(keys), "copies_per_key": 2, "bit_equal": True}

    # the compressed store: the codec on the card, two copies a key
    kv = mx.kv.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": KV_THRESHOLD})
    kv.init(keys, [NDArray(torch.zeros_like(w)) for w in weights])
    outs = [NDArray(torch.zeros_like(w)) for w in weights]
    grads = [[NDArray(c[i]) for c in copies] for i in keys]
    kv.push(keys, grads)
    kv.pull(keys, out=outs)
    torch.cuda.synchronize()
    host, nonzero = gc.GradientCompression(KV_THRESHOLD), 0
    for i in keys:
        deq = []
        for j, c in enumerate(copies):
            packed = host.quantize((i, j), c[i].cpu().numpy())
            nonzero += int(np.count_nonzero(packed))
            deq.append(host.dequantize(packed, tuple(c[i].shape)))
            if not np.array_equal(kv._residuals[(i, j)].cpu().numpy(),
                                  host._residuals[(i, j)].ravel()):
                raise RuntimeError(f"slice_kvstore: the compressed store's residual of key "
                                   f"{i}, copy {j} differs from the numpy codec's")
        if not np.array_equal(outs[i]._data.cpu().numpy(), deq[0] + deq[1]):
            raise RuntimeError(f"slice_kvstore: the compressed store's sum of key {i} "
                               f"differs from the numpy codec's")

    def compressed_round_trip(kv=kv, grads=grads, outs=outs):
        kv.push(keys, grads)
        kv.pull(keys, out=outs)

    timing["device_2bit"] = {"push_pull_ms": cuda_ms(compressed_round_trip,
                                                     iters=KV_TIMED_ROUNDS, warmup=1)}
    torch.cuda.synchronize()
    launches = {**{name: k.launches for name, k in library.KERNELS.items()},
                "rtc": rtc.launches}
    if any(launches.values()):
        raise RuntimeError(f"slice_kvstore: a kernel launched: {launches}")
    n_elements = sum(w.numel() for w in weights)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x, y = _spmd_batch()
        states = {}
        for store in ("device", None):
            gnet = vision.resnet50_v1()
            gnet.load_parameters(spmd["path"], ctx=mx.gpu(0))
            trainer = mx.gluon.Trainer(gnet.collect_params(), "sgd", dict(SPMD_SGD),
                                       kvstore=store)
            with mx.autograd.record():
                loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                    gnet(mx.nd.from_dlpack(x)), mx.nd.from_dlpack(y))
            loss.backward()
            trainer.step(BATCH)
            if trainer._kvstore is not None:
                raise RuntimeError("slice_kvstore: a store over one context")
            states[store] = _gluon_state(gnet, trainer, [loss])
        differ = _bit_equal_states(states["device"], states[None])
        if differ:
            raise RuntimeError(f"slice_kvstore: Trainer(kvstore='device') differs from "
                               f"kvstore=None in {len(differ)} tensors")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.remove(spmd["path"])
        os.remove(spmd["step1_path"])
    bytes_moved = sum(w.numel() * 4 for w in weights)
    emit("slice_kvstore", model="resnet50_v1", trainable_tensors=len(weights),
         trainable_params=sum(w.numel() for w in weights), stores=out,
         optimizer={"sgd": SGD, "in_store": True},
         held_to="multi_sgd_mom_update on the sum of the two copies, bit for bit",
         push_pull_ms=timing, push_bytes=2 * bytes_moved, pull_bytes=bytes_moved,
         compression={"store": "device", "threshold": KV_THRESHOLD,
                      "elements_per_copy": n_elements, "copies_per_key": 2,
                      "packed_bytes": 2 * sum(-(-w.numel() // 4) for w in weights),
                      "nonzero_code_bytes": nonzero,
                      "held_to": "the numpy codec on the host copies: pulled sums and "
                                 "residuals, bit for bit"},
         trainer_device_store_one_context="bit-equal to kvstore=None (no store)",
         launches=launches)
    return timing, launches


# slice_dist: gluon's resnet50_v1 trained by two dist_sync workers and one
# server, all started by mxnet_tpu_torch.launch on a free port; the workers
# share the card, 16 rows each of slice_spmd's batch of 32
DIST_WORKERS, DIST_STEPS = 2, 3
DIST_TIMEOUT_S = 600
# slice_group2ctx: a two-group MLP, group dev1 on cpu(0) and dev2 on gpu(0)
G2C = {"batch": 64, "in": 1024, "hidden": 512, "out": 10, "seed": 3}


def _dist_save(mx, path, tensors):
    """``.params`` of ``{store key: tensor}``."""
    mx.nd.save(path, {str(k): mx.nd.NDArray(t.detach().cpu()) for k, t in tensors.items()})


def _dist_load(mx, path):
    """``[(store key, numpy array)]`` of ``_dist_save``'s file, by key."""
    return sorted(((int(k), v.asnumpy()) for k, v in mx.nd.load(path).items()))


def _dist_counters(client):
    return {"push_s": client.rpc_seconds.get("push", 0.0),
            "pull_s": client.rpc_seconds.get("pull", 0.0), "wait_s": client.wait_seconds,
            "sent_bytes": client.sent_bytes, "recv_bytes": client.recv_bytes}


def _dist_worker(workdir):
    """One worker of ``slice_dist`` (a process of ``mxnet_tpu_torch.launch``;
    rank and size from ``DMLC_*``): its rows of the batch through
    ``Trainer(kvstore='dist_sync', update_on_kvstore=True)``.  Before the
    steps, one 2-bit compressed round of the first gradients through a
    store of its own; then ``DIST_STEPS`` steps, a digest of the pulled
    weights after each, the split of each step's time, and the launch
    counts of the steps.  Writes its files and ``rank{r}.json`` to
    ``workdir``."""
    import hashlib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_device(0)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.kernels import library
    from mxnet_tpu_torch import rtc
    rank, world = int(os.environ["DMLC_RANK"]), int(os.environ["DMLC_NUM_WORKER"])
    x, y = _spmd_batch()
    rows = BATCH // world
    xs = mx.nd.from_dlpack(x[rank * rows:(rank + 1) * rows].contiguous())
    ys = mx.nd.from_dlpack(y[rank * rows:(rank + 1) * rows].contiguous())
    net = vision.resnet50_v1()
    net.load_parameters(os.path.join(workdir, "w0.params"), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SPMD_SGD), kvstore="dist_sync",
                               update_on_kvstore=True)
    # store key i is trainer._params[i]; the trainable ones are pushed
    params = {i: p for i, p in enumerate(trainer._params) if p.grad_req != "null"}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mults = sorted({(p.lr_mult, p.wd_mult) for p in params.values()})

    def forward_backward():
        with mx.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        return loss

    def weights():
        return {i: p._tensor().detach() for i, p in params.items()}

    torch.cuda.synchronize()
    library.reset_launches()
    loss = forward_backward()
    _dist_save(mx, os.path.join(workdir, f"grads{rank}.params"),
               {i: p.grad()._data for i, p in params.items()})
    if rank == 0:
        _dist_save(mx, os.path.join(workdir, "w0_keys.params"), weights())
    # (c): the first gradients, 2-bit compressed, through a store of their own
    ckv = mx.kv.create("dist_sync")
    ckv.set_gradient_compression({"type": "2bit", "threshold": KV_THRESHOLD})
    ckeys = [f"c{i}" for i in params]
    ckv.init(ckeys, [mx.nd.zeros(p.shape, ctx=mx.gpu(0)) for p in params.values()])
    ckv.push(ckeys, [p.grad() for p in params.values()])
    sums = [mx.nd.zeros(p.shape, ctx=mx.gpu(0)) for p in params.values()]
    ckv.pull(ckeys, out=sums)
    if rank == 0:
        _dist_save(mx, os.path.join(workdir, "sums.params"),
                   {i: t._data for i, t in zip(params, sums)})
    ckv.close()
    digests, losses, steps = [], [], []
    client = None
    for i in range(DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i > 0:
            loss = forward_backward()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = _dist_counters(client) if client is not None else None
        apply0 = client.command("server_stats", b"")["value"]["apply_seconds"] \
            if client is not None and rank == 0 else None
        trainer.step(BATCH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        client = trainer._kvstore._client
        if before is not None:
            after = _dist_counters(client)
            d = {k: after[k] - before[k] for k in after}
            steps.append({"step": i + 1, "step_ms": (t2 - t0) * 1e3,
                          "forward_backward_ms": (t1 - t0) * 1e3,
                          "push_ms": d["push_s"] * 1e3, "wait_ms": d["wait_s"] * 1e3,
                          "pull_ms": (d["pull_s"] - d["wait_s"]) * 1e3,
                          "kvstore_ms": (t2 - t1) * 1e3, "push_bytes": d["sent_bytes"],
                          "pull_bytes": d["recv_bytes"]})
            if apply0 is not None:
                steps[-1]["server_apply_ms"] = (client.command("server_stats", b"")["value"]
                                                ["apply_seconds"] - apply0) * 1e3
        w = weights()
        digests.append(hashlib.sha256(torch.cat([t.reshape(-1) for t in w.values()]).cpu()
                                      .numpy().tobytes()).hexdigest())
        losses.append(float(loss._data.detach().mean()))
        if i == 0 and rank == 0:
            _dist_save(mx, os.path.join(workdir, "w1_keys.params"), w)
    torch.cuda.synchronize()
    launches = {**{name: k.launches for name, k in library.KERNELS.items()},
                "rtc": rtc.launches}
    trainer._kvstore.barrier()
    trainer._kvstore.close()
    if "jax" in sys.modules or "mxnet_tpu" in sys.modules:
        raise RuntimeError("a dist worker imported jax or mxnet_tpu")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "rows": rows, "keys": len(params), "mults": mults,
                   "digests": digests, "losses": losses, "steps": steps,
                   "launches": launches}, f)
    return 0


def run_slice_dist(mx, vision, Xavier):
    """``slice_dist`` and ``timing_dist``: ``DIST_WORKERS`` workers and a
    server started by ``mxnet_tpu_torch.launch``; (a) the workers' pulled
    weights bit-equal after every step; (b) the weights after step 1
    bit-equal to the port's CPU ``sgd_mom_update`` on the sum of the
    workers' saved step-1 gradients; (c) the compressed round's server sums
    bit-equal to ``gradient_compression``'s codec decoding both workers' payloads."""
    from mxnet_tpu_torch import gradient_compression as gc
    from mxnet_tpu_torch.launch import launch
    from mxnet_tpu_torch.ops.optimizer import sgd_mom_update
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch", "_build")
    workdir = tempfile.mkdtemp(prefix="dist_", dir=build)
    snap = _pool_snapshot()
    try:
        resnet50(vision, Xavier, 0).save_parameters(os.path.join(workdir, "w0.params"))
        t0 = time.perf_counter()
        rc = launch(DIST_WORKERS, [sys.executable, os.path.abspath(__file__), "--dist-worker",
                                   workdir], timeout=DIST_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"slice_dist: the launched job exited {rc}")
        ranks = []
        for r in range(DIST_WORKERS):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        w0 = _dist_load(mx, os.path.join(workdir, "w0_keys.params"))
        w1 = _dist_load(mx, os.path.join(workdir, "w1_keys.params"))
        grads = [_dist_load(mx, os.path.join(workdir, f"grads{r}.params"))
                 for r in range(DIST_WORKERS)]
        sums = _dist_load(mx, os.path.join(workdir, "sums.params"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    left = _pool_left(snap)
    failed = []
    if any(left.values()):
        failed.append(f"left behind: {left}")
    # (a)
    for r in range(1, DIST_WORKERS):
        if ranks[r]["digests"] != ranks[0]["digests"]:
            failed.append(f"(a) rank {r}'s weights differ from rank 0's")
    # (b)
    if ranks[0]["mults"] != [[1.0, 1.0]]:
        failed.append(f"(b) lr/wd multipliers {ranks[0]['mults']}")
    differ_b = []
    for (k, w), (k1, got), *gs in zip(w0, w1, *grads):
        if {k1, *(g[0] for g in gs)} != {k}:
            raise RuntimeError("slice_dist: the saved keys differ")
        weight = torch.from_numpy(w.copy())
        g = torch.from_numpy(gs[0][1] + gs[1][1])
        sgd_mom_update(weight, g, torch.zeros_like(weight), lr=SPMD_SGD["learning_rate"],
                       wd=SPMD_SGD["wd"], momentum=SPMD_SGD["momentum"],
                       rescale_grad=1.0 / BATCH)
        if not np.array_equal(weight.numpy(), got):
            differ_b.append(k)
    if differ_b:
        failed.append(f"(b) {len(differ_b)} keys differ from sgd_mom_update: {differ_b[:5]}")
    # (c)
    differ_c, nonzero = [], 0
    for j, (k, got) in enumerate(sums):
        packed = [torch.from_numpy(gc.GradientCompression(KV_THRESHOLD).encode_push(
            k, gr[j][1])["q2bit"]) for gr in grads]
        nonzero += sum(int(torch.count_nonzero(p)) for p in packed)
        want = gc.decode_2bit_sum(torch.stack(packed), KV_THRESHOLD, got.size)
        if not np.array_equal(want.numpy().reshape(got.shape), got):
            differ_c.append(k)
    if differ_c:
        failed.append(f"(c) {len(differ_c)} keys' sums differ from the codec: {differ_c[:5]}")
    launches = {name: sum(r["launches"][name] for r in ranks) for name in ranks[0]["launches"]}
    if any(launches.values()):
        failed.append(f"a kernel launched: {launches}")
    n_params = sum(w.size for _, w in w0)
    if n_params != RESNET50_TRAINABLE:
        failed.append(f"{n_params} trainable parameters")
    readings = {"losses": [r["losses"] for r in ranks], "keys": ranks[0]["keys"],
                "trainable_params": n_params, "launch_seconds": seconds}
    if failed:
        emit("slice_dist", failed=failed, **readings)
        raise RuntimeError(f"slice_dist: {failed[:6]}")
    emit("slice_dist", model="resnet50_v1", workers=DIST_WORKERS, servers=1,
         launcher="mxnet_tpu_torch.launch (port 0, sessions, lifelines)",
         store="dist_sync", update_on_kvstore=True, rows_per_worker=ranks[0]["rows"],
         n_steps=DIST_STEPS, optimizer={"sgd": SPMD_SGD, "rescale_grad": 1.0 / BATCH,
                                        "on": "the server, CPU"},
         held_to={"a": "the workers' pulled weights after every step, bit for bit",
                  "b": "sgd_mom_update on the CPU on the sum of the workers' step-1 "
                       "gradients, bit for bit, every key",
                  "c": "the 2-bit codec (threshold %g) decoding both workers' payloads, "
                       "bit for bit, every key" % KV_THRESHOLD},
         compression={"nonzero_code_bytes": nonzero, "keys": len(sums)},
         left_behind=left, tf32=False, cudnn_deterministic=True, launches=launches, **readings)
    steps = [s for r in ranks for s in r["steps"]]
    per_worker = [{"rank": r["rank"], "steps": r["steps"]} for r in ranks]
    step_ms = max(s["step_ms"] for s in steps)
    push_bytes = sum(s["push_bytes"] for s in steps) / len(steps)
    pull_bytes = sum(s["pull_bytes"] for s in steps) / len(steps)
    push_s = sum(s["push_ms"] for s in steps) / len(steps) / 1e3
    pull_s = sum(s["pull_ms"] for s in steps) / len(steps) / 1e3
    apply_ms = [s["server_apply_ms"] for s in ranks[0]["steps"]]
    timing = {"step_ms": step_ms, "img_per_s": BATCH / step_ms * 1e3,
              "timed_steps": [s["step"] for s in ranks[0]["steps"]], "workers": per_worker,
              "server_apply_ms": apply_ms,
              "wire_bytes_per_step_per_worker": {"push": push_bytes, "pull": pull_bytes},
              "dense_bytes_per_worker": 4 * n_params,
              "localhost_rate_gb_per_s": {"push": push_bytes / push_s / 1e9,
                                          "pull": pull_bytes / pull_s / 1e9},
              "label": "two workers and the server on one host, sharing one card; the "
                       "server's optimizer on its CPU"}
    emit("timing_dist", tf32=False, **timing)
    return timing, launches


def run_slice_group2ctx(mx, library):
    """``slice_group2ctx``: a two-group MLP bound with group ``dev1`` on
    ``cpu(0)`` and ``dev2`` on ``gpu(0)``, forward and backward, against
    the same symbol bound on ``gpu(0)`` alone; each group's output on its
    device."""
    from mxnet_tpu_torch.kernels import library as _lib
    c = G2C
    data = mx.sym.var("data")
    with mx.AttrScope(ctx_group="dev1"):
        h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=c["hidden"], no_bias=True,
                                                    name="fc1"), act_type="tanh", name="h")
    with mx.AttrScope(ctx_group="dev2"):
        out = mx.sym.FullyConnected(h, num_hidden=c["out"], no_bias=True, name="fc2")
    sym = mx.sym.Group([h, out])
    rng = np.random.RandomState(c["seed"])
    vals = {"data": rng.randn(c["batch"], c["in"]).astype(np.float32),
            "fc1_weight": (rng.randn(c["hidden"], c["in"]) / np.sqrt(c["in"])).astype(np.float32),
            "fc2_weight": (rng.randn(c["out"], c["hidden"]) /
                           np.sqrt(c["hidden"])).astype(np.float32)}

    def run(group2ctx):
        args = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in vals.items()}
        grads = {k: mx.nd.zeros(v.shape, ctx=mx.gpu(0)) for k, v in vals.items()}
        ex = sym.bind(mx.gpu(0), args, args_grad=grads, group2ctx=group2ctx)
        outs = ex.forward(is_train=True)
        ex.backward()
        torch.cuda.synchronize()
        return outs, grads

    _lib.reset_launches()
    outs, grads = run({"dev1": mx.cpu(0), "dev2": mx.gpu(0)})
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in library.KERNELS.items()}
    ref_outs, ref_grads = run(None)
    devices = {"h": (str(outs[0].context), outs[0]._data.device.type),
               "fc2": (str(outs[1].context), outs[1]._data.device.type)}
    failed = []
    if devices != {"h": ("cpu(0)", "cpu"), "fc2": ("gpu(0)", "cuda")}:
        failed.append(f"outputs on {devices}")
    errs = {}
    for name, got, want in ([("out:h", outs[0], ref_outs[0]), ("out:fc2", outs[1], ref_outs[1])]
                            + [(f"grad:{k}", grads[k], ref_grads[k]) for k in vals]):
        g, w = got.asnumpy(), want.asnumpy()
        err = float(np.abs(g - w).max())
        errs[name] = err
        if err > PARITY_ATOL * max(1.0, float(np.abs(w).max())) + PARITY_RTOL * float(
                np.abs(w).max()):
            failed.append(f"{name}: {err}")
    if any(launches.values()):
        failed.append(f"a kernel launched: {launches}")
    if failed:
        emit("slice_group2ctx", failed=failed, max_abs_err=errs)
        raise RuntimeError(f"slice_group2ctx: {failed}")
    emit("slice_group2ctx", shapes=c, groups={"dev1": "cpu(0)", "dev2": "gpu(0)"},
         held_to="the same symbol bound on gpu(0) alone", devices=devices,
         tolerance={"rtol": PARITY_RTOL, "atol": PARITY_ATOL, "of": "each tensor's scale"},
         max_abs_err=errs, launches=launches)
    return launches


# -- checkpoints -----------------------------------------------------------------
# slice_checkpoint: TrainStep and Module.fit, each resumed from a checkpoint
# taken in mid-run, bit for bit with the uninterrupted run
CKPT_STEPS, CKPT_SAVE_AT = 4, 2
CKPT_MODULE_BATCHES = 2          # a Module epoch; two epochs, the save after the first
# slice_checkpoint_serving: how often the repository polls, and how long
# a commit may take to be served
CKPT_WATCH_INTERVAL_S = 0.05
CKPT_SERVE_TIMEOUT_S = 120.0
CKPT_SERVE_REQUESTS = 32       # a full batch: every bucket of the ladder replays it
# timing_checkpoint: best of CKPT_TIMED_REPEATS; TrainStep steps with a save
# every CKPT_SAVE_EVERY of them
CKPT_TIMED_REPEATS = 3
CKPT_TIMED_STEPS, CKPT_SAVE_EVERY = 10, 5


def _launch_counts(library):
    from mxnet_tpu_torch import rtc
    return {**{name: k.launches for name, k in library.KERNELS.items()}, "rtc": rtc.launches}


def _ckpt_params(mx, vision, Xavier, path):
    """Full-width ``resnet50_v1()`` from ``Xavier()`` on seed 0, its shapes
    finished by one forward, saved to ``path``."""
    gpu = mx.gpu(0)
    src = vision.resnet50_v1()
    src.initialize(Xavier(), ctx=gpu, generator=torch.Generator().manual_seed(0))
    with mx.autograd.pause():
        src(mx.nd.zeros((1, 3, IMAGE, IMAGE), ctx=gpu))
    src.save_parameters(path)


def _ckpt_train_step(mx, vision, path, x, y):
    """A TrainStep of ``resnet50_v1()`` from ``path``; every such net has
    the same parameter names, so that one restores another's checkpoint."""
    from mxnet_tpu_torch import parallel
    net = vision.resnet50_v1(prefix="chip_ckpt_")
    net.load_parameters(path, ctx=mx.gpu(0))
    return parallel.TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                              dict(SPMD_SGD), parallel.make_mesh(dp=1), (x, y))


def _step_state(step):
    return {k: v.clone() for k, v in step.state_dict().items()}


def run_slice_checkpoint(mx, vision, Xavier, library):
    """``slice_checkpoint`` under cuDNN's deterministic algorithms; returns
    the launches of its two paths and a TrainStep with its batch, for
    ``timing_checkpoint``."""
    return _deterministic(_slice_checkpoint, mx, vision, Xavier, library)


def _slice_checkpoint(mx, vision, Xavier, library):
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    root = tempfile.mkdtemp(prefix="chip-ckpt-")
    try:
        path = os.path.join(root, "resnet50.params")
        _ckpt_params(mx, vision, Xavier, path)
        x, y = _spmd_batch()

        # TrainStep: uninterrupted, then saved after step CKPT_SAVE_AT and
        # resumed in a fresh step
        full = _ckpt_train_step(mx, vision, path, x, y)
        losses = [float(full(x, y)) for _ in range(CKPT_STEPS)]
        want = _step_state(full)
        del full
        run = _ckpt_train_step(mx, vision, path, x, y)
        torch.cuda.synchronize()
        library.reset_launches()
        for _ in range(CKPT_SAVE_AT):
            run(x, y)
        at_save = None
        with CheckpointManager(os.path.join(root, "trainstep"), async_save=True,
                               keep_last=0) as mgr:
            t0 = time.perf_counter()
            fut = run.save_checkpoint(mgr, CKPT_SAVE_AT)
            save_blocking_ms = (time.perf_counter() - t0) * 1e3
            at_save = _step_state(run)
            for _ in range(CKPT_STEPS - CKPT_SAVE_AT):
                run(x, y)     # writes the saved tensors in place at once
            fut.result(600)
            save_total_ms = mgr.stats()["last_save_total_ms"]
            fresh = _ckpt_train_step(mx, vision, path, x, y)
            t0 = time.perf_counter()
            ckpt = fresh.restore_checkpoint(mgr)
            restore_s = time.perf_counter() - t0
            restored = _step_state(fresh)
            resumed_losses = [float(fresh(x, y)) for _ in range(CKPT_STEPS - CKPT_SAVE_AT)]
        torch.cuda.synchronize()
        step_launches = _launch_counts(library)
        got, continued = _step_state(fresh), _step_state(run)
        ts = {"saved_step": ckpt.step, "tensors": len(want),
              "elements": sum(v.numel() for v in want.values()),
              "nbytes": sum(v.numel() * v.element_size() for v in want.values()),
              "losses": losses, "resumed_losses": resumed_losses,
              "restore_equals_save": _bit_equal_states(restored, at_save),
              "resumed_not_bit_equal": _bit_equal_states(got, want),
              "continued_not_bit_equal": _bit_equal_states(continued, want),
              "save_blocking_ms": save_blocking_ms, "save_total_ms": save_total_ms,
              "restore_s": restore_s, "launches": step_launches}
        del run, fresh, restored, at_save, continued

        # Module.fit with the fused step: two epochs, against one epoch with
        # module_checkpoint and one of the Module restore_module gives
        symbol = _symbol_resnet().resnet50_symbol(mx.sym, num_classes=1000)
        rng = np.random.RandomState(0)
        n = CKPT_MODULE_BATCHES * BATCH
        mx_ = rng.randn(n, 3, IMAGE, IMAGE).astype(np.float32)
        my = rng.randint(0, 1000, n).astype(np.float32)
        init = mx.mod.Module(symbol, context=mx.gpu(0))
        init.bind(data_shapes=[("data", (BATCH, 3, IMAGE, IMAGE))],
                  label_shapes=[("softmax_label", (BATCH,))])
        torch.manual_seed(0)
        init.init_params(Xavier())
        params = init.get_params()
        del init
        knobs = {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 1}

        def fit(mod, epochs, begin=0, callback=None):
            it = mx.io.NDArrayIter(mx_, my, batch_size=BATCH)
            metric = _step_losses(mx)
            with _Env(**knobs):
                mod.fit(it, num_epoch=epochs, begin_epoch=begin, eval_metric=metric,
                        kvstore=None, optimizer="sgd", optimizer_params=MODULE_SGD,
                        arg_params=params[0], aux_params=params[1],
                        epoch_end_callback=callback)
            torch.cuda.synchronize()
            return [float(v) for v in metric.values]

        whole = mx.mod.Module(symbol, context=mx.gpu(0))
        whole_losses = fit(whole, 2)
        mwant = _module_state(whole)
        del whole
        library.reset_launches()
        first = mx.mod.Module(symbol, context=mx.gpu(0))
        with CheckpointManager(os.path.join(root, "module"), async_save=True) as mgr:
            cb = mx.callback.module_checkpoint(first, os.path.join(root, "unused"),
                                               save_optimizer_states=True, manager=mgr)
            first_losses = fit(first, 1, callback=cb)
            mgr.wait()
            resumed, mckpt = mgr.restore_module(context=mx.gpu(0))
        resumed_losses = fit(resumed, 2, begin=1)
        module_launches = _launch_counts(library)
        mgot = _module_state(resumed)
        fs = resumed._fused
        mod_out = {"saved_step": mckpt.step, "tensors": len(mwant),
                   "blobs": sorted(mckpt.blobs), "losses": whole_losses,
                   "resumed_losses": first_losses + resumed_losses,
                   "resumed_not_bit_equal": _bit_diff(mgot, mwant),
                   "resumed_fused_steps": fs.steps if fs else 0,
                   "launches": module_launches}
        del first, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failed = []
    if ts["restore_equals_save"]:
        failed.append(f"TrainStep: the restore differs from the state at the save in "
                      f"{ts['restore_equals_save'][:4]}")
    for key in ("resumed_not_bit_equal", "continued_not_bit_equal"):
        if ts[key]:
            failed.append(f"TrainStep {key}: {len(ts[key])} tensors ({ts[key][:4]})")
    if mod_out["resumed_not_bit_equal"]:
        failed.append(f"Module resumed: {len(mod_out['resumed_not_bit_equal'])} tensors "
                      f"differ ({mod_out['resumed_not_bit_equal'][:4]})")
    if mod_out["saved_step"] != 1 or "optimizer_states" not in mod_out["blobs"]:
        failed.append(f"Module checkpoint: step {mod_out['saved_step']}, blobs "
                      f"{mod_out['blobs']}")
    if mod_out["resumed_fused_steps"] != CKPT_MODULE_BATCHES:
        failed.append(f"Module resumed: {mod_out['resumed_fused_steps']} fused steps")
    finite = all(np.isfinite(v).all() for v in (ts["losses"], mod_out["losses"]))
    for d in (ts, mod_out):
        for key in ("resumed_not_bit_equal", "continued_not_bit_equal", "restore_equals_save"):
            if key in d:
                d[key] = d[key][:8]
    emit("slice_checkpoint", model="resnet50_v1 under TrainStep; bench.py "
         "_resnet50_symbol(1000) under Module.fit, fused", batch=BATCH, image=IMAGE,
         steps=CKPT_STEPS, save_after_step=CKPT_SAVE_AT, cudnn_deterministic=True, tf32=False,
         held="bit for bit with the uninterrupted run", finite=finite, failed=failed,
         trainstep=ts, module=mod_out)
    if failed or not finite:
        raise RuntimeError(f"slice_checkpoint: {failed or 'non-finite losses'}")
    return {"trainstep": step_launches, "module": module_launches}


def _net_arrays(net, prefix):
    """``{"arg:name" / "aux:name": tensor}`` of a gluon net, the save format,
    each name's prefix replaced by ``prefix`` (nets are numbered apart)."""
    cut = len(net.prefix)
    return {f"{'aux' if p.is_aux else 'arg'}:{prefix}{n[cut:]}": p._tensor()
            for n, p in net.collect_params().items()}


def _await(cond, what, timeout=CKPT_SERVE_TIMEOUT_S):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"slice_checkpoint_serving: {what} within {timeout} s")
        time.sleep(0.005)
    return time.monotonic() - t0


def run_slice_checkpoint_serving(mx, vision, Xavier, library):
    """``slice_checkpoint_serving`` under cuDNN's deterministic algorithms;
    returns the launches of its run."""
    return _deterministic(_slice_checkpoint_serving, mx, vision, Xavier, library)


def _slice_checkpoint_serving(mx, vision, Xavier, library):
    from mxnet_tpu_torch import chaos, serving
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    gpu, c = mx.gpu(0), SERVE
    _fresh_ladders(mx)
    nets = [_resnet18(mx, vision, Xavier, seed=s) for s in (0, 1)]
    nets[0]._build_sym_graph()
    symbol, prefix = nets[0]._cached_graph[1], nets[0].prefix
    gen = torch.Generator().manual_seed(11)
    xs = torch.randn(CKPT_SERVE_REQUESTS, 3, c["image"], c["image"], generator=gen).numpy()
    with mx.autograd.pause():
        alone = [np.stack([net(mx.nd.array(x[None], ctx=gpu)).asnumpy()[0] for x in xs])
                 for net in nets]
    root = tempfile.mkdtemp(prefix="chip-ckpt-serve-")
    server = serving.ModelServer(max_batch_size=c["batch"], max_latency_ms=c["latency_ms"],
                                 max_queue_depth=c["queue_depth"], name="chip-ckpt-serve")
    repo = server.repository
    out = {}
    torch.cuda.synchronize()
    library.reset_launches()
    try:
        with CheckpointManager(root, keep_last=0, async_save=True) as mgr:
            mgr.save(1, arrays=_net_arrays(nets[0], prefix), symbol=symbol, block=True)
            repo.watch("resnet18", root, interval=CKPT_WATCH_INTERVAL_S)
            out["step1_served_after_s"] = _await(
                lambda: "resnet18" in repo.models(), "step 1 was not served")
            one = _serve_requests(server, "resnet18", xs)
            out["step1_max_abs_err_scaled"] = float(
                np.abs(one - alone[0]).max() / np.abs(alone[0]).max())

            t0 = time.monotonic()
            mgr.save(2, arrays=_net_arrays(nets[1], prefix), symbol=symbol, block=True)
            out["step2_commit_s"] = time.monotonic() - t0
            out["step2_served_after_s"] = out["step2_commit_s"] + _await(
                lambda: repo.latest_version("resnet18") == 2, "step 2 was not served")
            two = _serve_requests(server, "resnet18", xs)
            out["step2_max_abs_err_scaled"] = float(
                np.abs(two - alone[1]).max() / np.abs(alone[1]).max())
            entries = {e.bucket: e for e in server.cache.entries("resnet18")
                       if e.key[1] == 2}
            replay_vs_eager = {}
            for b, entry in sorted(entries.items()):
                got = entry.run_padded({"data": xs[:b]}, b)[0]
                ref = entry.executor.forward(is_train=False, data=xs[:b])[0].asnumpy()
                replay_vs_eager[b] = bool(np.array_equal(got, ref))
            out["step2_replay_vs_eager_bit_equal"] = replay_vs_eager

            chaos.arm("checkpoint/writer/manifest", "corrupt", count=1)
            try:
                mgr.save(3, arrays=_net_arrays(nets[0], prefix), symbol=symbol, block=True)
            finally:
                chaos.reset()
            out["step3_quarantined_after_s"] = _await(
                lambda: repo.corrupt_steps("resnet18", root) == [3],
                "step 3 was not quarantined")
            time.sleep(5 * CKPT_WATCH_INTERVAL_S)
            out["served_version_after_step3"] = repo.latest_version("resnet18")
            three = _serve_requests(server, "resnet18", xs)
            out["after_step3_max_abs_err_scaled"] = float(
                np.abs(three - alone[1]).max() / np.abs(alone[1]).max())
            out["committed_steps"] = mgr.steps()
        torch.cuda.synchronize()
        launches = _launch_counts(library)
    finally:
        _close_server(server)
        shutil.rmtree(root, ignore_errors=True)
    failed = []
    if max(out["step1_max_abs_err_scaled"], out["step2_max_abs_err_scaled"]) > SERVE_TOL:
        failed.append("served answers past SERVE_TOL of the step's net alone")
    if not entries or not all(replay_vs_eager.values()):
        failed.append(f"step 2's replays against eager: {replay_vs_eager}")
    if out["served_version_after_step3"] != 2 or \
            out["after_step3_max_abs_err_scaled"] > SERVE_TOL:
        failed.append("step 2 did not go on serving after the corrupt step 3")
    emit("slice_checkpoint_serving", model="resnet18_v1", batch=c["batch"], image=c["image"],
         watch_interval_s=CKPT_WATCH_INTERVAL_S, requests=CKPT_SERVE_REQUESTS,
         tolerance={"answers": SERVE_TOL, "replays": "bit for bit"}, failed=failed,
         launches=launches, **out)
    if failed:
        raise RuntimeError(f"slice_checkpoint_serving: {failed}")
    return launches


def _ckpt_times(root, arrays, repeats=CKPT_TIMED_REPEATS):
    """bench.py ``measure_checkpoint``'s readings on ``arrays``: every
    figure the best of ``repeats``."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.checkpoint.manager import _snapshot_one, _Snapshot
    sync_ms, blocking_ms, restore_s, snap_ms = [], [], [], []
    with CheckpointManager(os.path.join(root, "sync"), keep_last=1, async_save=False) as mgr:
        for i in range(repeats):
            t0 = time.perf_counter()
            mgr.save(i + 1, arrays=arrays, block=True)
            sync_ms.append((time.perf_counter() - t0) * 1e3)
    with CheckpointManager(os.path.join(root, "async"), keep_last=1, async_save=True) as mgr:
        for i in range(repeats):
            t0 = time.perf_counter()
            mgr.save(i + 1, arrays=arrays)   # returns after the snapshot
            blocking_ms.append((time.perf_counter() - t0) * 1e3)
            mgr.wait()
        for _ in range(repeats):
            t0 = time.perf_counter()
            ckpt = mgr.restore()            # checksums verified
            restore_s.append(time.perf_counter() - t0)
        nbytes = mgr.stats()["last_save_bytes"]
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = _Snapshot()
        held = [_snapshot_one(snap, k, v) for k, v in arrays.items()]
        snap.wait()
        snap_ms.append((time.perf_counter() - t0) * 1e3)
        del held
    for k, v in arrays.items():
        src = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        if not torch.equal(ckpt.arrays[k], src.cpu()):
            raise RuntimeError(f"timing_checkpoint: restored {k} differs from the saved tensor")
    blk, syn = min(blocking_ms), min(sync_ms)
    return {"ckpt_save_blocking_ms": blk, "ckpt_save_sync_ms": syn,
            "blocking_fraction": blk / syn if syn else None,
            "ckpt_restore_s": min(restore_s), "state_bytes": nbytes,
            "snapshot_ms": min(snap_ms),
            "snapshot_gb_per_s": nbytes / (min(snap_ms) / 1e3) / 1e9,
            "samples": {"sync_ms": sync_ms, "blocking_ms": blocking_ms,
                        "restore_s": restore_s, "snapshot_ms": snap_ms}}


def time_checkpoint(mx, vision, Xavier):
    """``timing_checkpoint``: bench.py ``measure_checkpoint`` on
    ``BENCH_CKPT_MB`` of host state and on a ResNet-50 ``TrainStep``'s
    state on the card, and the step with an async save every
    ``CKPT_SAVE_EVERY`` steps beside the same loop without saves."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    mb = max(1, config.get("BENCH_CKPT_MB"))
    n = mb * 1024 * 1024 // 4 // 8
    rng = np.random.RandomState(0)
    host = {f"w{i}": rng.randn(n).astype(np.float32) for i in range(8)}
    root = tempfile.mkdtemp(prefix="chip-ckpt-time-")
    try:
        host_t = _ckpt_times(os.path.join(root, "host"), host)
        del host
        path = os.path.join(root, "resnet50.params")
        _ckpt_params(mx, vision, Xavier, path)
        x, y = _spmd_batch()
        step = _ckpt_train_step(mx, vision, path, x, y)
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
        device_t = _ckpt_times(os.path.join(root, "device"), step.state_dict())

        def loop(save, run_no):
            with CheckpointManager(os.path.join(root, f"loop{run_no}"), keep_last=1,
                                   async_save=True) as mgr:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(CKPT_TIMED_STEPS):
                    step(x, y)
                    if save and (i + 1) % CKPT_SAVE_EVERY == 0:
                        step.save_checkpoint(mgr, i + 1)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / CKPT_TIMED_STEPS
                mgr.wait()
            return ms

        runs = {"no_save": [], "save_every_5": []}
        for r in range(2):     # interleaved: no save, save, no save, save
            runs["no_save"].append(loop(False, 2 * r))
            runs["save_every_5"].append(loop(True, 2 * r + 1))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"host_state": host_t, "trainstep_state": device_t,
           "step_ms": {k: min(v) for k, v in runs.items()}, "step_ms_samples": runs,
           "steps": CKPT_TIMED_STEPS, "save_every": CKPT_SAVE_EVERY}
    out["step_ms_save_overhead"] = out["step_ms"]["save_every_5"] - out["step_ms"]["no_save"]
    emit("timing_checkpoint", bench_ckpt_mb=mb, tf32=False,
         clock="host perf_counter around a synchronized loop; saves and restores on the "
               "host clock", **out)
    return out


# slice_telemetry: slice_module's run with the step lanes on; the JAX
# package's bar (telemetry/steps.py): named lanes >= 90 % of a step's wall
TELEMETRY_COVERAGE = 0.90
TELEMETRY_TIMELINE_EVERY = 2
# timing_telemetry: bench.py's budget of a disabled span and of a disabled
# trace stage + flight record; the fit's steps timed with the lanes on and off
TELEMETRY_BUDGET_NS = 1000
TELEMETRY_HOOK_CALLS = 50000
TELEMETRY_TIMED_BATCHES = 8
# slice_profiler: the device operations printed
PROFILER_TOP = 10


class _LogLines(logging.Handler):
    """Keeps each formatted record of the logger it is attached to."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(self.format(record))


def run_slice_telemetry(mx, Xavier, library):
    """``slice_module``'s full-width ``_resnet50_symbol(1000)`` (batch 32,
    224x224, fp32, 4 batches from one saved Xavier state, cuDNN's
    deterministic algorithms) through ``Module.fit``, the per-parameter loop
    and the fused step, each once with ``telemetry.enable()`` and
    ``StepTimeline(frequent=2)`` and once with telemetry off: over the steps
    after the first (the fused step's capture), the named lanes hold at
    least ``TELEMETRY_COVERAGE`` of the wall; ``step_breakdown()``'s lanes
    plus ``other`` equal its wall; every tensor after the run equals the run
    with telemetry off bit for bit.  Prints each form's lanes in ms a step.
    Returns the kernels' launches and, for ``timing_telemetry``, the modules
    of the runs with telemetry on and the host data."""
    return _deterministic(_slice_telemetry, mx, Xavier, library)


def _slice_telemetry(mx, Xavier, library):
    from mxnet_tpu_torch import telemetry
    symbol, x, y, params = _module_inputs(mx, Xavier)
    handler = _LogLines()
    logger = logging.getLogger("chip_smoke.step_timeline")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    states, out, mods, failed = {}, {}, {}, []
    library.reset_launches()
    for form, fused in (("loop", 0), ("fused", 1)):
        for on in (False, True):
            metric = _step_losses(mx)
            marks = []
            timeline = mx.callback.StepTimeline(frequent=TELEMETRY_TIMELINE_EVERY, logger=logger)

            def callback(p, marks=marks, timeline=timeline):
                marks.append(telemetry.step_breakdown())
                timeline(p)

            telemetry.reset_step_stats()
            if on:
                telemetry.enable()
            try:
                mod, flags = _module_fit(mx, symbol, x, y, params,
                                         {"MXNET_FUSED_STEP": fused, "MXNET_SCAN_STEPS": 1},
                                         BATCH, metric, callback=callback)
            finally:
                telemetry.disable()
            bd = telemetry.step_breakdown()
            states[(form, on)] = {"loss": torch.stack(metric.values), **_module_state(mod)}
            if not on:
                if bd["steps"]:
                    failed.append(f"{form}: {bd['steps']} steps timed with telemetry off")
                continue
            mods[form] = mod
            # a batch's callback runs before its step closes: the second
            # batch's reading holds the first step (the capture) alone
            first = marks[1]
            n = bd["steps"] - first["steps"]
            wall = bd["wall_s"] - first["wall_s"]
            lanes = {k: bd["lanes"][k] - first["lanes"].get(k, 0.0) for k in bd["lanes"]}
            coverage = sum(lanes.values()) / wall
            audit = abs(sum(bd["lanes"].values()) + bd["other_s"] - bd["wall_s"]) / bd["wall_s"]
            out[form] = {"steps": bd["steps"], "steps_fused": sum(flags),
                         "steps_after_capture": n,
                         "ms_per_step_after_capture": wall / n * 1e3,
                         "lanes_ms_per_step": {k: v / n * 1e3 for k, v in lanes.items()},
                         "other_ms_per_step": (bd["other_s"] - first["other_s"]) / n * 1e3,
                         "coverage_after_capture": coverage,
                         "first_step_ms": first["wall_s"] * 1e3,
                         "lanes_plus_other_vs_wall_rel": audit}
            if bd["steps"] != MODULE_BATCHES or sum(flags) != (MODULE_BATCHES if fused else 0):
                failed.append(f"{form}: {bd['steps']} steps timed, {sum(flags)} fused")
            if coverage < TELEMETRY_COVERAGE:
                failed.append(f"{form}: the lanes hold {coverage:.3f} of the wall after the "
                              f"capture (bar {TELEMETRY_COVERAGE})")
            if audit > 1e-9:
                failed.append(f"{form}: lanes + other part from the wall by {audit}")
    launches = _launch_counts(library)
    for form in ("loop", "fused"):
        differ = _bit_diff(states[(form, True)], states[(form, False)])
        out[form]["not_bit_equal_to_telemetry_off"] = differ[:8]
        if differ:
            failed.append(f"{form}: {len(differ)} tensors differ with telemetry on "
                          f"({differ[:4]})")
    logger.removeHandler(handler)
    if len(handler.lines) != 2 * ((MODULE_BATCHES - 1) // TELEMETRY_TIMELINE_EVERY):
        failed.append(f"StepTimeline logged {len(handler.lines)} lines")
    emit("slice_telemetry", model="bench.py _resnet50_symbol(1000)", batch=BATCH, image=IMAGE,
         batches=MODULE_BATCHES, cudnn_deterministic=True, coverage_bar=TELEMETRY_COVERAGE,
         tensors=len(states[("loop", False)]), step_timeline=handler.lines,
         kernel_launches=launches, failed=failed, **out)
    if failed:
        raise RuntimeError(f"slice_telemetry: {failed}")
    return launches, mods, x, y


def _disabled_hook_ns():
    """bench.py's ``measure_telemetry_overhead`` and ``measure_trace_overhead``
    on the port: best of 3 of ``TELEMETRY_HOOK_CALLS`` disabled spans (ns a
    span), and of as many disabled trace starts with a stage plus disarmed
    flight records (ns a hook event, three an iteration)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import flight, trace
    was_flight = flight.enabled()
    telemetry.disable()
    trace.disable()
    flight.disable()
    try:
        span_s = trace_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(TELEMETRY_HOOK_CALLS):
                with telemetry.span("bench/noop"):
                    pass
            span_s = min(span_s, (time.perf_counter() - t0) / TELEMETRY_HOOK_CALLS)
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(TELEMETRY_HOOK_CALLS):
                tr = trace.start("bench")
                with tr.stage("noop"):
                    pass
                flight.record("bench", "noop", value=1)
            trace_s = min(trace_s, (time.perf_counter() - t0) / (3 * TELEMETRY_HOOK_CALLS))
    finally:
        if was_flight:
            flight.enable()
    return span_s * 1e9, trace_s * 1e9


def _fit_step_times(mx, mod, x, y, knobs, telemetry_on=False, profiled=False):
    """ms a step of ``Module.fit`` over ``TELEMETRY_TIMED_BATCHES`` batches of
    a Module already bound and initialized, from the second batch's end to
    the last's: by CUDA events recorded at each batch's end, and by the
    host's clock."""
    from mxnet_tpu_torch import profiler, telemetry
    n = TELEMETRY_TIMED_BATCHES
    reps = -(-n * BATCH // len(x))
    it = mx.io.NDArrayIter(np.concatenate([x] * reps)[:n * BATCH],
                           np.concatenate([y] * reps)[:n * BATCH], batch_size=BATCH)
    events, host = [], []

    def mark(_p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        host.append(time.perf_counter())

    with _Env(**knobs):
        if telemetry_on:
            telemetry.enable()
        if profiled:
            profiler.start()
        try:
            mod.fit(it, num_epoch=1, eval_metric="acc", kvstore=None, optimizer="sgd",
                    optimizer_params=MODULE_SGD, batch_end_callback=mark)
            torch.cuda.synchronize()
        finally:
            telemetry.disable()
            if profiled:
                profiler.stop()
                profiler.dumps(reset=True)
    return {"events_ms": events[1].elapsed_time(events[-1]) / (n - 2),
            "host_ms": (host[-1] - host[1]) * 1e3 / (n - 2)}


def time_telemetry(mx, mods, x, y, smi):
    """``timing_telemetry``, before the process's first profiler session:
    bench.py's ``measure_telemetry_overhead`` (a disabled span) and
    ``measure_trace_overhead`` (a disabled trace start and stage plus a
    disarmed flight record, per hook event), each held to
    ``TELEMETRY_BUDGET_NS``; the ResNet-50 fused step's ms with the
    telemetry lanes on and off; the per-parameter loop's ms a step with
    ``mx.profiler`` running (``profile_device_sync`` on, no device trace)
    and stopped.  Each pair runs off, on, on, off in one process and reports
    the mean of each side, beside the card's name and power limit."""
    from mxnet_tpu_torch import profiler
    span_ns, trace_ns = _disabled_hook_ns()
    pairs = {"fused_step_telemetry": (mods["fused"], {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 1},
                                      "telemetry_on"),
             "loop_step_profiler": (mods["loop"], {"MXNET_FUSED_STEP": 0, "MXNET_SCAN_STEPS": 1},
                                    "profiled")}
    out = {}
    for name, (mod, knobs, flag) in pairs.items():
        runs = {False: [], True: []}
        for on in (False, True, True, False):
            runs[on].append(_fit_step_times(mx, mod, x, y, knobs, **{flag: on}))
        out[name] = {side: {k: sum(r[k] for r in runs[on]) / len(runs[on])
                            for k in ("events_ms", "host_ms")}
                     for side, on in (("off", False), ("on", True))}
        out[name]["on_over_off_events"] = out[name]["on"]["events_ms"] / \
            out[name]["off"]["events_ms"]
    failed = [f"{k} {v:.1f} ns over the budget of {TELEMETRY_BUDGET_NS}"
              for k, v in (("disabled span", span_ns), ("disabled trace + flight", trace_ns))
              if v >= TELEMETRY_BUDGET_NS]
    emit("timing_telemetry", nvidia_smi=smi, tf32=False, batches=TELEMETRY_TIMED_BATCHES,
         telemetry_disabled_span_ns=span_ns, trace_disabled_overhead_ns=trace_ns,
         budget_ns=TELEMETRY_BUDGET_NS, profiler_device_sync=profiler.device_sync_enabled(),
         failed=failed, **out)
    if failed:
        raise RuntimeError(f"timing_telemetry: {failed}")
    return {"span_ns": span_ns, "trace_ns": trace_ns, **out}


# slice_numerics: slice_module's runs with the numerics observatory armed; a
# step's grad_norm against the 2-norm of the per-parameter loop's gradients,
# and the narrow symbol's loss stat against the mean of softmax_ce's loss
NUMERICS_GRAD_REL = 1e-5
NUMERICS_LOSS_REL = 1e-6
# timing_numerics: bench.py measure_numerics_overhead's disarmed calls, its MLP
# (PIPE's 16 x 256 at batch 512) in windows of K = 8, 8 steps an epoch, the
# median of 3 epochs a block, the best of 3 rounds, and the JAX package's own
# budget, printed beside the result (not a hold); ResNet-50's fused step in
# off, warn and skip, alternating blocks
NUMERICS_HOOK_CALLS = 100000
NUMERICS_MLP = {"k": 8, "steps": 8, "epochs": 3, "rounds": 3}
NUMERICS_REFERENCE_BUDGET_PCT = 5.0
NUMERICS_STATS = ("grad_norm", "param_norm", "update_ratio", "loss")


def _armed_fit(mx, numerics, mode, *args, **kw):
    """``_module_fit`` with the numerics observatory in ``mode`` (history and
    counters cleared first); the observatory is off again afterwards."""
    numerics._reset_for_tests()
    numerics.configure(mode=mode)
    try:
        return _module_fit(mx, *args, **kw)
    finally:
        numerics.configure(mode="off")


def _loop_grad_norm(mx, symbol, x, y, params):
    """The 2-norm of the per-parameter loop's gradients of the first batch
    from ``params`` (forward and backward of a fresh Module, in f64)."""
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (BATCH, 3, IMAGE, IMAGE))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(arg_params=params[0], aux_params=params[1])
    mod.forward(mx.io.DataBatch([mx.nd.array(x[:BATCH], ctx=mx.gpu(0))],
                                [mx.nd.array(y[:BATCH], ctx=mx.gpu(0))]), is_train=True)
    mod.backward()
    grads = [mod._exec.grad_dict[n]._data for n in mod._param_names if n in mod._exec.grad_dict]
    return float(torch.stack([(g.double() ** 2).sum() for g in grads]).sum().sqrt())


def run_slice_numerics(mx, library, inputs, off):
    """The numerics observatory on the card (``MXNET_NUMERICS``), inside the
    fused step's and the scanned window's CUDA graphs, on ``slice_module``'s
    full-width ``_resnet50_symbol(1000)`` (its inputs, batch 32, fp32, 4
    batches, cuDNN's deterministic algorithms): ``warn`` over the fused step
    and over windows of ``MODULE_SCAN``, every tensor bit for bit
    ``slice_module``'s ``off`` run and its captures, replays and dispatches
    equal, the stats finite, the first step's ``grad_norm`` within
    ``NUMERICS_GRAD_REL`` of the 2-norm of the loop's gradients; ``skip``
    with ``train/poison_grad`` on window 1, bit for bit an ``off`` run over
    batches 3-4 from the same state, 2 skipped updates; ``halt`` raising
    ``NonFiniteError`` at step 1 with its dump written (to a temporary
    directory, removed).  Then ``slice_module_kernels``' narrow symbol fused
    and armed: layernorm and softmax_ce launch at the capture only, and each
    step's loss stat is within ``NUMERICS_LOSS_REL`` of the mean of the
    loss softmax_ce computed.  Every dump goes to a temporary directory,
    removed afterwards.  Returns the kernels' launches."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
                         "_build")
    os.makedirs(build, exist_ok=True)
    dump_dir = tempfile.mkdtemp(prefix="slice_numerics-", dir=build)
    try:
        with _Env(MXNET_NUMERICS_DUMP_DIR=dump_dir):
            return _deterministic(_slice_numerics, mx, library, inputs, off, dump_dir)
    finally:
        shutil.rmtree(dump_dir, ignore_errors=True)


def _slice_numerics(mx, library, inputs, off, dump_dir):
    from mxnet_tpu_torch import chaos
    from mxnet_tpu_torch.base import NonFiniteError
    from mxnet_tpu_torch.telemetry import numerics
    from mxnet_tpu_torch.train_step import CAPTURE_WARMUP
    t_phase = time.perf_counter()
    symbol, x, y, params = inputs
    runs = {"fused": {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 1},
            "scan": {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": MODULE_SCAN}}
    out, failed = {}, []
    library.reset_launches()
    for name, knobs in runs.items():
        metric = _step_losses(mx)
        mx.profiler.reset_dispatch_counts()
        t0 = time.perf_counter()
        mod, _flags = _armed_fit(mx, numerics, "warn", symbol, x, y, params, knobs, BATCH,
                                 metric)
        fs = mod._fused if name == "fused" else mod._scan
        state = {"loss": torch.stack(metric.values), **_module_state(mod)}
        differ = _bit_diff(state, off[name]["state"])
        counts = {"captures": fs.captures, "replays": fs.replays, "steps": fs.steps}
        hist = numerics.history()
        out[name] = {"seconds": time.perf_counter() - t0, **counts,
                     "dispatches": mx.profiler.dispatch_counts(), "history": hist,
                     "summary": numerics.summary(), "not_bit_equal_to_off": differ[:8]}
        del mod, fs
        gc.collect()
        if differ:
            failed.append(f"warn {name}: {len(differ)} tensors differ from off ({differ[:4]})")
        if counts != {k: off[name][k] for k in counts} or \
                out[name]["dispatches"] != off[name]["dispatches"]:
            failed.append(f"warn {name}: {counts}, {out[name]['dispatches']} against off's "
                          f"{off[name]['dispatches']}")
        if len(hist) != MODULE_BATCHES or any(
                e["nonfinite"] or not all(np.isfinite(e[k]) for k in NUMERICS_STATS)
                for e in hist):
            failed.append(f"warn {name}: stats not finite or not one a step")
    grad_norm = _loop_grad_norm(mx, symbol, x, y, params)
    grad_rel = {name: abs(out[name]["history"][0]["grad_norm"] - grad_norm) / grad_norm
                for name in runs}
    if max(grad_rel.values()) > NUMERICS_GRAD_REL:
        failed.append(f"first step's grad_norm against the loop's gradients: {grad_rel}")
    resnet_launches = _launch_counts(library)

    # skip: window 1 poisoned, dropped on the device; held to a manual skip
    chaos.arm("train/poison_grad", "raise", hits=1, count=1)
    try:
        mod, _flags = _armed_fit(mx, numerics, "skip", symbol, x, y, params, runs["scan"],
                                 BATCH, _step_losses(mx))
    finally:
        chaos.reset()
    skip = {"summary": numerics.summary(), "history": numerics.history()}
    got = _module_state(mod)
    del mod
    gc.collect()
    tail = MODULE_SCAN * BATCH
    ref, _flags = _module_fit(mx, symbol, x[tail:], y[tail:], params, runs["scan"], BATCH,
                              _step_losses(mx))
    differ = _bit_diff(got, _module_state(ref))
    del ref, got
    gc.collect()
    skip["not_bit_equal_to_manual_skip"] = differ[:8]
    if differ or skip["summary"]["skipped_updates"] != MODULE_SCAN:
        failed.append(f"skip: {len(differ)} tensors differ from a manual skip ({differ[:4]}), "
                      f"{skip['summary']['skipped_updates']} updates skipped")

    # halt: typed at step 1, its dump written
    halt = None
    chaos.arm("train/poison_grad", "raise", hits=1, count=1)
    try:
        _armed_fit(mx, numerics, "halt", symbol, x, y, params, runs["scan"], BATCH,
                   _step_losses(mx))
    except NonFiniteError as e:
        halt = {"step": e.step, "stat": e.stat, "where": e.where,
                "dump_written": bool(e.dump_path) and os.path.exists(e.dump_path),
                "dump_dir_is_the_temporary_one": os.path.dirname(e.dump_path or "") == dump_dir}
    finally:
        chaos.reset()
        gc.collect()
    if halt is None or halt["step"] != 1 or not halt["dump_written"]:
        failed.append(f"halt: {halt}")

    # the kernels' symbol fused and armed: launches at the capture only, and
    # the loss stat against the kernel's loss
    c = MODULE_KERNELS
    symbol_k, xk, yk, args_k = _kernels_inputs(mx)
    names = [k for k in library.KERNELS if k in ("layernorm", "softmax_ce")]
    per_batch, losses = [], []

    def callback(p):
        per_batch.append({k: library.KERNELS[k].launches for k in names})
        losses.append(float(p.locals["self"].get_outputs()[0]._data.float().mean()))

    library.reset_launches()
    mod, flags = _armed_fit(mx, numerics, "warn", symbol_k, xk, yk, (args_k, {}), runs["fused"],
                            c["rows"], mx.metric.Loss(), callback=callback)
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    hist = numerics.history()
    loss_rel = [abs(e["loss"] - l) / abs(l) for e, l in zip(hist, losses)]
    want_fused = [{k: CAPTURE_WARMUP + 1 for k in names}] * c["batches"]
    kernels = {"launches_after_each_batch": per_batch, "steps_fused": sum(flags),
               "loss_stat": [e["loss"] for e in hist], "kernel_loss_mean": losses,
               "loss_rel_err": loss_rel}
    if per_batch != want_fused or sum(flags) != c["batches"]:
        failed.append(f"kernels: launches {per_batch}, {sum(flags)} steps fused")
    if len(loss_rel) != c["batches"] or max(loss_rel) > NUMERICS_LOSS_REL:
        failed.append(f"kernels: loss stat against softmax_ce's loss {loss_rel}")
    seconds = time.perf_counter() - t_phase
    emit("slice_numerics", model="bench.py _resnet50_symbol(1000)", batch=BATCH, image=IMAGE,
         batches=MODULE_BATCHES, scan=MODULE_SCAN, optimizer={"sgd": MODULE_SGD},
         cudnn_deterministic=True, warn=out, loop_grad_norm=grad_norm,
         grad_norm_rel_err_vs_loop=grad_rel, grad_tolerance=NUMERICS_GRAD_REL, skip=skip,
         halt=halt, resnet50_kernel_launches=resnet_launches, kernels_symbol=kernels,
         loss_tolerance=NUMERICS_LOSS_REL, failed=failed, seconds=seconds)
    if failed:
        raise RuntimeError(f"slice_numerics: {failed}")
    return {"resnet50": resnet_launches, "kernels_capture": per_batch[0],
            "kernels_replays": {k: per_batch[-1][k] - per_batch[0][k] for k in names}}


def _numerics_disabled_ns(numerics):
    """bench.py's ``numerics_disabled_ns``: ``armed()`` plus the early-out of
    ``observe_window``, best of 3 of ``NUMERICS_HOOK_CALLS``."""
    assert not numerics.armed()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(NUMERICS_HOOK_CALLS):
            numerics.armed()
            numerics.observe_window(None, "bench", 0, 0)
        best = min(best, (time.perf_counter() - t0) / NUMERICS_HOOK_CALLS)
    return best * 1e9


def _time_numerics_mlp(mx, Xavier, numerics):
    """bench.py ``measure_numerics_overhead``'s window: the MLP scanned at K =
    8, armed (warn) against off, one Module a mode (each captured under its
    mode), a settling epoch then the median of ``epochs`` a block, blocks
    alternating by round, the round with the least armed/off ratio kept."""
    c, n = PIPE, NUMERICS_MLP
    rng = np.random.RandomState(0)
    x = rng.randn(n["steps"] * c["batch"], c["features"]).astype(np.float32)
    y = rng.randint(0, c["classes"], n["steps"] * c["batch"]).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=c["batch"])
    fit = {"kvstore": None, "optimizer": "sgd",
           "optimizer_params": {"learning_rate": 0.01, "momentum": 0.9}}
    knobs = {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": n["k"]}
    mods = {}
    for mode in ("off", "warn"):
        numerics.configure(mode=mode)
        mod = mx.mod.Module(_pipe_mlp(mx), context=mx.gpu(0))
        try:
            with _Env(**knobs):
                torch.manual_seed(0)
                mod.fit(it, num_epoch=1, initializer=Xavier(), **fit)
            torch.cuda.synchronize()
        finally:
            numerics.configure(mode="off")
        mods[mode] = mod

    def epoch(mode):
        numerics.configure(mode=mode)
        mx.profiler.reset_dispatch_counts()
        try:
            with _Env(**knobs):
                t0 = time.perf_counter()
                mods[mode].fit(it, num_epoch=1, **fit)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            numerics.configure(mode="off")
        return wall / n["steps"] * 1e3, mx.profiler.dispatch_counts().get("total", 0) / n["steps"]

    rounds = []
    for _ in range(n["rounds"]):
        r = {}
        for mode in ("off", "warn"):
            epoch(mode)
            runs = sorted(epoch(mode) for _ in range(n["epochs"]))
            r[mode] = runs[len(runs) // 2]
        rounds.append(r)
    best = min(rounds, key=lambda r: r["warn"][0] / r["off"][0])
    return {"model": f"MLP {c['layers']} x {c['width']}", "batch": c["batch"], "k": n["k"],
            "steps": n["steps"], "step_ms_off": best["off"][0], "step_ms_armed": best["warn"][0],
            "overhead_pct": max(0.0, best["warn"][0] / best["off"][0] - 1.0) * 100.0,
            "dispatches_per_step_off": best["off"][1],
            "dispatches_per_step_armed": best["warn"][1],
            "rounds_step_ms": [{m: r[m][0] for m in r} for r in rounds],
            "reference_budget_pct": NUMERICS_REFERENCE_BUDGET_PCT,
            "reference_budget_note": "the JAX package's own gate, printed beside the result; "
                                     "not a TPU number and not a hold"}


def _graph_pool_bytes(graph):
    """Bytes of the segments in a CUDA graph's private memory pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _time_numerics_resnet(mx, numerics, telemetry, inputs):
    """The ResNet-50 fused step in off, warn and skip: one Module a mode,
    each captured under its mode, its graph's private pool in bytes and the
    allocator's reserved and allocated bytes it added (cache emptied before
    and after), then ``_fit_step_times`` blocks off, warn, skip, skip,
    warn, off with the step lanes on."""
    symbol, x, y, params = inputs
    knobs = {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 1}
    modes = ("off", "warn", "skip")
    mods, mem = {}, {}
    for mode in modes:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        numerics.configure(mode=mode)
        try:
            mods[mode], _flags = _module_fit(mx, symbol, x, y, params, knobs, BATCH, "acc")
        finally:
            numerics.configure(mode="off")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem[mode] = {"graph_pool": _graph_pool_bytes(mods[mode]._fused._graph),
                     "reserved": torch.cuda.memory_reserved() - r0,
                     "allocated": torch.cuda.memory_allocated() - a0}
    runs = {m: [] for m in modes}
    for mode in modes + modes[::-1]:
        numerics.configure(mode=mode)
        telemetry.reset_step_stats()
        try:
            t = _fit_step_times(mx, mods[mode], x, y, knobs, telemetry_on=True)
        finally:
            numerics.configure(mode="off")
        bd = telemetry.step_breakdown()
        t["lanes_ms_per_step"] = {k: v / bd["steps"] * 1e3 for k, v in bd["lanes"].items()}
        runs[mode].append(t)
    del mods
    gc.collect()
    out = {}
    for mode in modes:
        r = runs[mode]
        out[mode] = {k: sum(t[k] for t in r) / len(r) for k in ("events_ms", "host_ms")}
        out[mode]["lanes_ms_per_step"] = {
            k: sum(t["lanes_ms_per_step"][k] for t in r) / len(r)
            for k in r[0]["lanes_ms_per_step"]}
        out[mode]["device_memory_after_capture_bytes"] = mem[mode]
        out[mode]["blocks_events_ms"] = [t["events_ms"] for t in r]
    for mode in ("warn", "skip"):
        out[mode]["over_off_events"] = out[mode]["events_ms"] / out["off"]["events_ms"]
        out[mode]["extra_ms_per_step"] = out[mode]["events_ms"] - out["off"]["events_ms"]
        out[mode]["extra_pool_bytes"] = mem[mode]["graph_pool"] - mem["off"]["graph_pool"]
        out[mode]["extra_reserved_bytes"] = mem[mode]["reserved"] - mem["off"]["reserved"]
        out[mode]["extra_allocated_bytes"] = mem[mode]["allocated"] - mem["off"]["allocated"]
    return out


def time_numerics(mx, Xavier, inputs, smi):
    """``timing_numerics``, before the process's first profiler session: bench.py's
    ``measure_numerics_overhead`` on the card (``disabled_ns``, held under
    ``TELEMETRY_BUDGET_NS``; the MLP's window armed against off in ms a step,
    its dispatches a step held equal, the JAX package's 5 % budget printed
    beside it), and the ResNet-50 fused step's ms a step in off, warn and skip
    by CUDA events and the host's clock, with its step lanes and the extra
    device memory of the armed graphs, beside the card's name and power
    limit."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import numerics
    t0 = time.perf_counter()
    disabled_ns = _numerics_disabled_ns(numerics)
    mlp = _time_numerics_mlp(mx, Xavier, numerics)
    resnet = _time_numerics_resnet(mx, numerics, telemetry, inputs)
    failed = []
    if disabled_ns >= TELEMETRY_BUDGET_NS:
        failed.append(f"disabled check {disabled_ns:.1f} ns over {TELEMETRY_BUDGET_NS}")
    if mlp["dispatches_per_step_armed"] != mlp["dispatches_per_step_off"]:
        failed.append("MLP: dispatches a step differ armed and off")
    gc.collect()
    torch.cuda.empty_cache()
    emit("timing_numerics", nvidia_smi=smi, tf32=False, disabled_ns=disabled_ns,
         disabled_budget_ns=TELEMETRY_BUDGET_NS, mlp=mlp,
         resnet50_fused={"model": "bench.py _resnet50_symbol(1000)", "batch": BATCH,
                         "batches_a_block": TELEMETRY_TIMED_BATCHES,
                         "order": "off, warn, skip, skip, warn, off", **resnet},
         failed=failed, seconds=time.perf_counter() - t0)
    if failed:
        raise RuntimeError(f"timing_numerics: {failed}")
    return {"disabled_ns": disabled_ns, "mlp": mlp, "resnet50": resnet}


def run_slice_profiler(mx, library):
    """``slice_module_kernels``' narrow symbol (FullyConnected, LayerNorm,
    FullyConnected, ``MakeLoss(softmax_cross_entropy)``) through
    ``Module.fit``'s per-parameter loop for 3 batches inside a telemetry
    span, with ``mx.profiler`` running (``profile_all``, ``profile_memory``)
    and ``MXNET_PROFILER_XPLANE_DIR`` set to a temporary directory, deleted
    afterwards.  ``dump()``'s chrome trace must parse and hold the ops'
    records, the ``device_memory`` counter lane and the span; ``dispatch_counts()`` one ``graph`` a forward and one a backward;
    the device trace (torch.profiler's chrome trace) must count each
    kernel of the path as often as its launch counter did in the same run
    (layernorm's ``ln_fwd_kernel`` and softmax_ce's ``smce_kernel_*``, one
    a step each, in the forward of every forward-and-backward) and hold the
    span as a ``record_function`` range.  Prints the top device operations
    of that trace.  Then ``_profiled_fused_fit`` holds the ``train:*`` lane
    in a fused-step run.  Returns the launches of both runs."""
    from mxnet_tpu_torch import profiler, telemetry
    c = MODULE_KERNELS
    symbol, x, y, args = _kernels_inputs(mx)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    xdir = tempfile.mkdtemp(prefix="slice_profiler-", dir=build)
    saved = dict(profiler.KWARGS)
    span = "chip_smoke/slice_profiler/fit"
    try:
        with _Env(MXNET_PROFILER_XPLANE_DIR=xdir):
            profiler.set_config(profile_all=True, profile_memory=True, aggregate_stats=True,
                                filename=os.path.join(xdir, "profile.json"))
            profiler.dumps(reset=True)
            profiler.reset_dispatch_counts()
            library.reset_launches()
            telemetry.enable()
            profiler.start()
            try:
                with telemetry.span(span):
                    _mod, flags = _module_fit(
                        mx, symbol, x, y, (args, {}),
                        {"MXNET_FUSED_STEP": 0, "MXNET_SCAN_STEPS": 1}, c["rows"],
                        mx.metric.Loss())
            finally:
                profiler.stop()
                telemetry.disable()
        launches = _launch_counts(library)
        dispatch = profiler.dispatch_counts()
        table = profiler.dumps(aggregate=True)
        profiler.dump()
        with open(os.path.join(xdir, "profile.json")) as f:
            host = json.load(f)["traceEvents"]
        trace_path = profiler.last_device_trace()
        with open(trace_path) as f:
            device = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(trace_path)
    finally:
        profiler.KWARGS.update(saved)
        profiler.dumps(reset=True)
        shutil.rmtree(xdir, ignore_errors=True)
    ops = sorted({e["name"] for e in host if e["cat"] == "operator"})
    counters = sorted({e["name"] for e in host if e["ph"] == "C"})
    spans = [e for e in host if e["cat"] == "span" and e["name"] == span]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    counted = {"layernorm": sum("ln_fwd_kernel" in e["name"] for e in kernels),
               "softmax_ce": sum("smce_kernel" in e["name"] for e in kernels)}
    device_spans = [e for e in device if e.get("name") == span]
    top = {}
    for e in kernels:
        t = top.setdefault(e["name"], [0, 0.0])
        t[0] += 1
        t[1] += float(e.get("dur", 0.0))
    top = [{"name": k[:100], "calls": n, "device_ms": us / 1e3}
           for k, (n, us) in sorted(top.items(), key=lambda kv: -kv[1][1])[:PROFILER_TOP]]
    fused = _profiled_fused_fit(mx, profiler, symbol, x, y, args, library)
    launches = {k: n + fused["launches"].get(k, 0) for k, n in launches.items()}
    failed = list(fused["failed"])
    if not ops:
        failed.append("no op records in the dump")
    if "device_memory" not in counters:
        failed.append(f"counter lanes {counters}")
    if len(spans) != 1:
        failed.append(f"{len(spans)} spans named {span} in the dump")
    if dispatch.get("graph") != 2 * c["batches"] or sum(flags):
        failed.append(f"dispatches {dispatch}, {sum(flags)} fused steps")
    for name, n in counted.items():
        loop_n = launches[name] - fused["launches"].get(name, 0)
        if n != loop_n or n != c["batches"]:
            failed.append(f"{name}: {n} kernels in the device trace, {loop_n} launches "
                          f"counted, {c['batches']} steps")
    if not device_spans:
        failed.append("the span is not in the device trace")
    emit("slice_profiler", symbol="data (64, 768) -> FullyConnected(768) -> LayerNorm -> "
         "FullyConnected(1000) -> MakeLoss(softmax_cross_entropy)", batches=c["batches"],
         ops=ops, counter_lanes=counters, dispatch_counts=dispatch,
         kernels_in_device_trace=counted, kernel_launches=launches,
         device_trace_events=len(device), device_trace_kernels=len(kernels),
         device_trace_bytes=trace_bytes,
         device_span_cats=sorted({e.get("cat") for e in device_spans}),
         top_device_ops=top, dumps_table=table.splitlines()[:16],
         fused={k: v for k, v in fused.items() if k != "failed"}, failed=failed)
    if failed:
        raise RuntimeError(f"slice_profiler: {failed}")
    return launches


def _profiled_fused_fit(mx, profiler, symbol, x, y, args, library):
    """The same narrow symbol through the fused step for ``batches``
    batches, ``mx.profiler`` running without a device trace: the dump
    holds the fused step's ``train:fused_step_total`` counter lane (the
    loop has no ``train:*`` lane, as in the JAX package) at the number of
    steps, and ``dispatch_counts()`` one ``fused_step`` a step."""
    c = MODULE_KERNELS
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    xdir = tempfile.mkdtemp(prefix="slice_profiler-fused-", dir=build)
    saved = dict(profiler.KWARGS)
    try:
        with _Env(MXNET_PROFILER_XPLANE_DIR=""):
            profiler.set_config(profile_all=True, profile_memory=True,
                                filename=os.path.join(xdir, "profile.json"))
            profiler.dumps(reset=True)
            profiler.reset_dispatch_counts()
            library.reset_launches()
            profiler.start()
            try:
                _mod, flags = _module_fit(
                    mx, symbol, x, y, (args, {}),
                    {"MXNET_FUSED_STEP": 1, "MXNET_SCAN_STEPS": 1}, c["rows"],
                    mx.metric.Loss())
            finally:
                profiler.stop()
        launches = _launch_counts(library)
        dispatch = profiler.dispatch_counts()
        profiler.dump()
        with open(os.path.join(xdir, "profile.json")) as f:
            host = json.load(f)["traceEvents"]
    finally:
        profiler.KWARGS.update(saved)
        profiler.dumps(reset=True)
        shutil.rmtree(xdir, ignore_errors=True)
    steps = [e["args"]["value"] for e in host
             if e["ph"] == "C" and e["name"] == "train:fused_step_total"]
    failed = []
    if not steps or steps[-1] != c["batches"] or sum(flags) != c["batches"]:
        failed.append(f"fused: train:fused_step_total {steps}, {sum(flags)} fused steps")
    if dispatch.get("fused_step") != c["batches"]:
        failed.append(f"fused: dispatches {dispatch}")
    return {"train_fused_step_total": steps, "dispatch_counts": dispatch,
            "launches": launches, "failed": failed}


def kernel_row(entry, launches, max_abs_err, t, **extra):
    return {"name": entry.name, "route": entry.route, "source": entry.source,
            "replaces": entry.replaces, "launches": launches, "max_abs_err": max_abs_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_device_ms": t["kernel_device_ms"],
            "kernel_self_device_ms": t["kernel_self_device_ms"],
            "library_device_ms": t["library_device_ms"], **extra}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; one CUDA device "
              "is needed", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, rtc
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.kernels import build, library
    from mxnet_tpu_torch.ops.optimizer import (multi_all_finite, multi_sgd_mom_update,
                                               sgd_mom_update)
    from mxnet_tpu_torch.ops.attention import FlashAttention, flash_attention
    from mxnet_tpu_torch.ops.layer_norm import LayerNormFn, fused_layer_norm
    from mxnet_tpu_torch.ops import softmax_ce as smce
    from mxnet_tpu_torch.ops.softmax_ce import SoftmaxCE, plain_softmax_ce
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import pipeline, tp
    from mxnet_tpu_torch.train_step import (CAPTURE_WARMUP, build_train_step,
                                            capture_train_step)

    tf32_defaults = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                     "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32=False)

    t0 = time.perf_counter()
    compiled = build.build()
    emit("build", sources=build.sources(), nvcc=build.nvcc(), flags=list(build.NVCC_FLAGS),
         per_source_seconds=compiled, seconds=time.perf_counter() - t0,
         tensor_core_instructions=tensor_core_instructions(build))

    entry = library.get("softmax_ce")
    ln_entry, attn_entry = library.get("layernorm"), library.get("attention")
    main_err = check_softmax_ce(entry, SoftmaxCE, plain_softmax_ce, smce)
    ln_err = check_layernorm(ln_entry, LayerNormFn)
    attn_err, attn_gen_err = check_attention(attn_entry, FlashAttention)

    step, x, y, launches = run_slice(build_train_step, library)
    step_bf16, xb, yb, bf16_launches = run_slice_bf16(build_train_step, vision, Xavier,
                                                      library, smce)
    run_parity(build_train_step, vision, Xavier)
    run_parity_tf32_default(build_train_step, vision, Xavier, tf32_defaults)
    run_parity_bf16(build_train_step, vision, Xavier)
    graph = run_graph_step(build_train_step, capture_train_step, CAPTURE_WARMUP, vision,
                           Xavier, library)
    mtu = run_multi_tensor_update(build_train_step, sgd_mom_update, multi_sgd_mom_update,
                                  multi_all_finite)
    nd_steps, nd_launches, nd_invokes = run_slice_nd(mx, library, vision, Xavier,
                                                     build_train_step)
    nd_kernel_launches = run_nd_kernels(mx, library, fused_layer_norm, flash_attention)
    gluon_steps, gluon_calls = run_slice_gluon(mx, vision, Xavier, build_train_step, library)
    gluon_ln_launches = run_slice_gluon_kernels(mx, library, fused_layer_norm)
    hybrid_steps = run_slice_hybridize(mx, vision, Xavier, library)
    module_mods, module_batch, module_sbatch, module_inputs, module_off = run_slice_module(
        mx, Xavier, library)
    module_kernel_launches = run_slice_module_kernels(mx, library, fused_layer_norm)
    numerics_launches = run_slice_numerics(mx, library, module_inputs, module_off)
    del module_off
    telemetry_launches, telemetry_mods, telemetry_x, telemetry_y = run_slice_telemetry(
        mx, Xavier, library)
    time_telemetry(mx, telemetry_mods, telemetry_x, telemetry_y, smi)
    del telemetry_mods
    time_numerics(mx, Xavier, module_inputs, smi)
    del module_inputs
    forward, tf_launches = run_transformer_slice(library, tp, pipeline)
    run_transformer_parity(tp, pipeline)
    mesh_launches, mesh_err, mesh_fns = run_slice_mesh(library, parallel)
    mesh_ms = time_mesh_phases(mesh_fns)
    ring_chunk_events = time_ring_chunk_events(attn_entry)
    gen_engine, gen_launches = run_slice_generation(library, serving)
    run_parity_generation(serving)
    gen_host = time_generation_host(gen_engine)
    serve_net, serve_launches = run_slice_serving(mx, vision, Xavier, library)
    serve_t = time_serving(serve_net)
    serve_kernel_launches = run_slice_serving_kernels(mx, library, serving, Xavier)
    data_launches = run_slice_data(mx, library, Xavier)
    pipe_runners, pipe_t = time_data_pipeline(mx, Xavier)
    gdata_launches, gdata_ds, gdata_net, gdata_trainer = run_slice_gluon_data(
        mx, vision, Xavier, library, rtc)
    gdata_t, gdata_runner = time_gluon_data(mx, gdata_ds, gdata_net, gdata_trainer)
    del gdata_ds, gdata_net, gdata_trainer
    run_rtc_semantics(mx, nd, rtc)
    rtc_state, rtc_launches, rtc_err = run_rtc_full_width(mx, nd, rtc, library, vision,
                                                          Xavier, sgd_mom_update)
    # each phase sets every count to 0 (mx.rtc's too) before its path runs
    spmd_steps, spmd_launches, spmd = run_slice_spmd(mx, vision, Xavier, library)
    spmd_ranks_t, spmd_ranks_launches = run_slice_spmd_ranks(spmd)
    kv_t, kv_launches = run_slice_kvstore(mx, vision, Xavier, library, multi_sgd_mom_update,
                                          spmd)
    del spmd
    _dist_t, dist_launches = run_slice_dist(mx, vision, Xavier)
    g2c_launches = run_slice_group2ctx(mx, library)
    ckpt_launches = run_slice_checkpoint(mx, vision, Xavier, library)
    ckpt_serve_launches = run_slice_checkpoint_serving(mx, vision, Xavier, library)
    time_checkpoint(mx, vision, Xavier)

    replay = capture_train_step(step, x, y)
    replay_bf16 = capture_train_step(step_bf16, xb, yb)
    configs = {"fp32_eager": lambda: step(x, y), "fp32_graph": lambda: replay(x, y),
               "bf16_eager": lambda: step_bf16(xb, yb),
               "bf16_graph": lambda: replay_bf16(xb, yb)}
    nd_configs = {f"nd_{'fp32' if dt == 'float32' else 'bf16'}_eager": fn
                  for dt, fn in nd_steps.items()}
    gluon_configs = {f"gluon_{'fp32' if dt == 'float32' else 'bf16'}_eager": fn
                     for dt, fn in gluon_steps.items()}
    hybrid_configs = {f"hybrid_{'fp32' if dt == 'float32' else 'bf16'}": fn
                      for dt, fn in hybrid_steps.items()}
    module_configs = time_module_configs(mx, module_mods, module_batch, module_sbatch)
    step_ms = time_step_configs({**configs, **nd_configs, **gluon_configs, **hybrid_configs,
                                 **module_configs, **spmd_steps})
    nd_invoke = time_nd_invoke(mx)
    smce_host, ln_host = host_bound_times(entry, ln_entry)
    rtc_host = rtc_host_bound_times(rtc_state, sgd_mom_update, rtc)
    smce_t = time_softmax_ce(entry, mx, rtc, smce_host)
    # the profiler slows the host, so its own idle share overstates the
    # idle time of an unprofiled step: set its busy time against step_ms too
    timed = profile_step_configs(configs, step_ms)
    fp32 = timed["fp32_eager"]
    emit("timing", tf32=False, train_step_ms=fp32["step_ms"], img_per_s=fp32["img_per_s"],
         softmax_ce=smce_t, train_step_profile=fp32["profile"],
         device_idle_share_vs_step_ms=fp32["device_idle_share_vs_step_ms"], configs=timed)
    nd_timed = profile_step_configs(nd_configs, step_ms)
    emit("timing_nd", tf32=False, invoke_host_us=nd_invoke,
         invokes_per_step=nd_invokes,
         steps={name: {**t, "eager_build_train_step_ms": step_ms[name[3:]]}
                for name, t in nd_timed.items()})

    gluon_timed = profile_step_configs(gluon_configs, step_ms)
    emit("timing_gluon", tf32=False, steps={
        name: {**t, "eager_build_train_step_ms": step_ms[name[6:]],
               "nd_step_ms": step_ms[f"nd_{name[6:]}"],
               "kernel_launches_per_step": sum(
                   k["calls_per_step"] for k in t["profile"]["by_kind"].values()),
               "multi_sgd_mom_update_calls_per_step":
                   gluon_calls["float32" if "fp32" in name else "bfloat16"]}
        for name, t in gluon_timed.items()})

    hybrid_timed = profile_step_configs(hybrid_configs, step_ms)
    emit("timing_hybridize", tf32=False, steps={
        name: {**t, "gluon_step_ms": step_ms[f"gluon_{name[7:]}_eager"],
               "eager_build_train_step_ms": step_ms[f"{name[7:]}_eager"],
               "kernel_launches_per_step": sum(
                   k["calls_per_step"] for k in t["profile"]["by_kind"].values())}
        for name, t in hybrid_timed.items()})
    emit("timing_module", tf32=False, **time_module(module_configs, step_ms))
    spmd_timed = profile_step_configs(spmd_steps, step_ms)
    emit("timing_spmd", tf32=False, steps=spmd_timed,
         eager_build_train_step_ms=step_ms["fp32_eager"],
         captured_build_train_step_ms=step_ms["fp32_graph"],
         ranks=spmd_ranks_t, kvstore=kv_t)

    c = GPT2_SMALL
    fwd_ms = cuda_ms(forward, iters=10, warmup=2)
    ln_t, attn_t = time_layernorm(ln_entry, ln_host), time_attention(attn_entry)
    ring_chunk_t = time_ring_chunk(attn_entry, ring_chunk_events)
    fwd_profile = step_breakdown(forward)
    emit("timing_transformer", tf32=False, forward_ms=fwd_ms,
         tokens_per_s=c["batch"] * c["seq"] / fwd_ms * 1e3, layernorm=ln_t, attention=attn_t,
         ring_chunk=ring_chunk_t, mesh_phase_ms=mesh_ms, forward_profile=fwd_profile,
         device_idle_share_vs_forward_ms=1.0 - fwd_profile["device_busy_ms_per_step"] / fwd_ms)

    axpy_t, sgd_t = time_rtc(rtc_state, sgd_mom_update, rtc_host, multi_sgd_mom_update,
                             mtu["ms"])
    emit("timing_rtc", tf32=False, axpy=axpy_t, sgd_mom_pass=sgd_t)
    gen_attn_t = time_generation(gen_engine, attn_entry, gen_host)
    profile_serving(serve_net, serve_t)
    profile_data_pipeline(pipe_runners, pipe_t)
    profile_gluon_data(gdata_runner, gdata_t)
    profiler_launches = run_slice_profiler(mx, library)

    kernels = [kernel_row(entry, launches[entry.name], main_err, smce_t,
                          launches_by_path={
                              "slice": launches[entry.name],
                              "slice_bf16": bf16_launches[entry.name],
                              "slice_nd": {dt: nd_launches[dt][entry.name]
                                           for dt in nd_launches},
                              "graph_step_capture": {dt: g["softmax_ce_launches_capture"]
                                                     for dt, g in graph.items()},
                              "graph_step_replays": {dt: g["softmax_ce_launches_replays"]
                                                     for dt, g in graph.items()},
                              "slice_module_kernels": {
                                  k: module_kernel_launches[k][entry.name]
                                  for k in ("loop", "fused")},
                              "slice_data": data_launches[entry.name],
                              "slice_gluon_data": gdata_launches[entry.name],
                              "slice_spmd": spmd_launches[entry.name],
                              "slice_spmd_ranks": spmd_ranks_launches[entry.name],
                              "slice_kvstore": kv_launches[entry.name],
                              "slice_dist": dist_launches[entry.name],
                              "slice_group2ctx": g2c_launches[entry.name],
                              "slice_checkpoint_trainstep":
                                  ckpt_launches["trainstep"][entry.name],
                              "slice_checkpoint_module": ckpt_launches["module"][entry.name],
                              "slice_checkpoint_serving": ckpt_serve_launches[entry.name],
                              "slice_telemetry": telemetry_launches[entry.name],
                              "slice_numerics": {
                                  "resnet50": numerics_launches["resnet50"][entry.name],
                                  "kernels_capture":
                                      numerics_launches["kernels_capture"][entry.name],
                                  "kernels_replays":
                                      numerics_launches["kernels_replays"][entry.name]},
                              "slice_profiler": profiler_launches[entry.name]},
                          host_us_per_call=smce_t["host_us_per_call"],
                          launch_floor_device_ms=smce_t["launch_floor_device_ms"],
                          lm_head={dt: {key: t[key] for key in (
                              "shape", "ms", "kernel_device_ms", "library_ms",
                              "library_device_ms", "bound_ms", "bound_by", "bound_share_device")}
                              for dt, t in smce_t["lm_head"].items()}),
               kernel_row(ln_entry, tf_launches[ln_entry.name], ln_err, ln_t,
                          launches_by_path={
                              "slice_transformer": tf_launches[ln_entry.name],
                              "slice_mesh": mesh_launches[ln_entry.name],
                              "slice_nd": nd_kernel_launches[ln_entry.name],
                              "slice_gluon_kernels": gluon_ln_launches[ln_entry.name],
                              "slice_module_kernels": {
                                  k: module_kernel_launches[k][ln_entry.name]
                                  for k in ("loop", "fused")},
                              "slice_module_kernels_hybridize":
                                  module_kernel_launches["hybridize"],
                              "slice_serving": serve_launches[ln_entry.name],
                              "slice_serving_kernels": {
                                  "capture": serve_kernel_launches["layernorm_capture"],
                                  "replays": serve_kernel_launches["layernorm_replays"]},
                              "slice_data": data_launches[ln_entry.name],
                              "slice_gluon_data": gdata_launches[ln_entry.name],
                              "slice_spmd": spmd_launches[ln_entry.name],
                              "slice_spmd_ranks": spmd_ranks_launches[ln_entry.name],
                              "slice_kvstore": kv_launches[ln_entry.name],
                              "slice_dist": dist_launches[ln_entry.name],
                              "slice_group2ctx": g2c_launches[ln_entry.name],
                              "slice_checkpoint_trainstep":
                                  ckpt_launches["trainstep"][ln_entry.name],
                              "slice_checkpoint_module": ckpt_launches["module"][ln_entry.name],
                              "slice_checkpoint_serving": ckpt_serve_launches[ln_entry.name],
                              "slice_telemetry": telemetry_launches[ln_entry.name],
                              "slice_numerics": {
                                  "resnet50": numerics_launches["resnet50"][ln_entry.name],
                                  "kernels_capture":
                                      numerics_launches["kernels_capture"][ln_entry.name],
                                  "kernels_replays":
                                      numerics_launches["kernels_replays"][ln_entry.name]},
                              "slice_profiler": profiler_launches[ln_entry.name]},
                          host_us_per_call=ln_t["host_us_per_call"]),
               kernel_row(attn_entry, tf_launches[attn_entry.name], attn_err, attn_t,
                          launches_by_path={
                              "slice_transformer": tf_launches[attn_entry.name],
                              "slice_generation": gen_launches[attn_entry.name],
                              "slice_serving_kernels_generate":
                                  serve_kernel_launches["attention_generate"],
                              "slice_mesh": mesh_launches[attn_entry.name],
                              "slice_nd": nd_kernel_launches[attn_entry.name],
                              "slice_data": data_launches[attn_entry.name],
                              "slice_gluon_data": gdata_launches[attn_entry.name],
                              "slice_spmd": spmd_launches[attn_entry.name],
                              "slice_spmd_ranks": spmd_ranks_launches[attn_entry.name],
                              "slice_kvstore": kv_launches[attn_entry.name],
                              "slice_dist": dist_launches[attn_entry.name],
                              "slice_group2ctx": g2c_launches[attn_entry.name],
                              "slice_checkpoint_trainstep":
                                  ckpt_launches["trainstep"][attn_entry.name],
                              "slice_checkpoint_module": ckpt_launches["module"][attn_entry.name],
                              "slice_checkpoint_serving": ckpt_serve_launches[attn_entry.name],
                              "slice_telemetry": telemetry_launches[attn_entry.name],
                              "slice_numerics": numerics_launches["resnet50"][attn_entry.name],
                              "slice_profiler": profiler_launches[attn_entry.name]},
                          slice_mesh_max_abs_err=mesh_err,
                          ring_chunk={key: {k: t[k] for k in (
                              "shape", "causal", "ms", "kernel_device_ms", "plain_ms",
                              "library_ms", "library_device_ms", "bound_ms", "bound_by")}
                              for key, t in ring_chunk_t.items()},
                          generation_prefill={"max_abs_err": attn_gen_err, **{
                              key: gen_attn_t[key] for key in (
                                  "shape", "ms", "kernel_device_ms", "plain_ms", "library_ms",
                                  "library_device_ms", "bound_ms", "bound_by")}},
                          bound_cuda_cores_ms=attn_t["bound_cuda_cores_ms"],
                          bf16={key: attn_t["bf16"][key] for key in (
                              "ms", "kernel_device_ms", "kernel_self_device_ms",
                              "library_ms", "library_device_ms", "bound_ms", "bound_by")}),
               {"name": "rtc", "route": f"nvrtc {rtc.ARCH}", "source": "mxnet_tpu_torch/rtc.py",
                "replaces": "mxnet_tpu/rtc.py:88", "launches": rtc_launches["rtc"],
                "launches_by_path": {"rtc_full_width": rtc_launches["rtc"],
                                     "slice_gluon_data": gdata_launches["rtc"],
                                     "slice_spmd": spmd_launches["rtc"],
                                     "slice_spmd_ranks": spmd_ranks_launches["rtc"],
                                     "slice_kvstore": kv_launches["rtc"],
                                     "slice_dist": dist_launches["rtc"],
                                     "slice_checkpoint_trainstep":
                                         ckpt_launches["trainstep"]["rtc"],
                                     "slice_checkpoint_module": ckpt_launches["module"]["rtc"],
                                     "slice_checkpoint_serving": ckpt_serve_launches["rtc"],
                                     "slice_telemetry": telemetry_launches["rtc"],
                                     "slice_numerics": numerics_launches["resnet50"]["rtc"],
                                     "slice_profiler": profiler_launches["rtc"]},
                "max_abs_err": rtc_err, **{k: axpy_t[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "timed": f"the doc axpy over {RESNET50_TRAINABLE} f32",
                "kernel_sources": "chip_smoke.py AXPY_SRC, SGD_MOM_SRC",
                "host_us_per_launch_before_profiler":
                    sgd_t["host_us_per_launch_before_profiler"],
                "graph_replay_ms": sgd_t["graph_replay_ms"],
                "sgd_mom_pass": {k: sgd_t[k] for k in (
                    "tensors", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                    "host_us_per_launch_before_profiler", "host_us_per_launch",
                    "ms_after_profiler", "graph_replay_ms",
                    "graph_replay_back_to_back_ms", "launch_breakdown_us", "library",
                    "library_ms", "library_device_ms")}}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(_dist_worker(sys.argv[2]))
    sys.exit(main())
