#!/usr/bin/env python3
"""Drive kpvid_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100. It
imports nothing of JAX or of the JAX package, and:

1. builds the CUDA kernels from ``kpvid_tpu_torch/csrc`` (one nvcc per
   source, started together), prints the build time, and reads the built
   library's SASS (``cuobjdump -sass``): every bf16 conv kernel must hold
   tensor-core instructions (``HGMMA`` or ``HMMA``);
2. holds every kernel of the generation path against its plain PyTorch
   version, on the card, at the shapes the path gives it at ``Config()``
   with 4 requests (N = 4 * 32 frames): float32 with TF32 off (rtol 1e-4,
   atol 1e-4) and bfloat16 (max |kernel - plain| <= 2% of max |plain|: the
   kernel rounds once, the plain version rounds the conv output and then
   the affine); #1+, the split first conv's per-frame part with oct0a's
   BN and ReLU (an f32 addend row a sample), beside the route it replaced;
   the soft-argmax from f32 and bf16 maps and the Gaussian render into f32
   and bf16 maps on both grids (bf16 maps within one bf16 step), at the
   slice's shapes and at batch 32's. Every kernel is timed two
   ways: its device time (``device_ms``: launches captured in one CUDA
   graph, the replays timed with CUDA events) and a host loop of launches
   between two CUDA events (``time_ms``), which includes the host's launch
   cost. The plain version is timed by the host loop; for the conv, one
   ``F.conv2d`` call in channels_last bfloat16 with the BN scale folded
   into the weights (a yardstick the port never calls) by its device time.
   It prints for every conv shape its TFLOP/s, its share of the bound and
   its ratio to ``F.conv2d``. Then the same checks, f32 and bf16, at the
   shapes of each of the daemon's buckets (N = 32 to 1,024 frames);
3. serves 4 requests through ``InferenceEngine`` at ``Config()`` with random
   weights from a seed (BN statistics and biases randomized), checks the
   shapes, the uint8 outputs, the mask range, that a seed gives the same
   video twice, and that every generate launched 8 / 1 / 2 / 1 / 2 / 28 kernels;
   then runs the whole path in float32 through the kernels and through the
   plain versions on the card and compares them;
4. times ``generate`` at batch 32 (1,024 frames, bfloat16), each of its
   stages both ways, and the same call through the plain versions; and
   says whether the pose decoder's raw maps reach the soft-argmax
   contiguous (else what the copy costs);
5. serve: starts the HTTP daemon (``make_server`` on 127.0.0.1, port 0,
   buckets 1..32, warm-up on) over an ``InferenceEngine`` at ``Config()``
   and sends it 96 ``POST /v1/generate`` requests from 16 client threads
   in a spawned process of their own (PNGs drawn from seed 0, alternating
   160x120 and 120x160; npz and a few GIFs), once with the depth-1 pipeline
   and once without. It checks every response, that the launch counters
   show 8 / 1 / 2 / 1 / 2 / 28 per dispatched batch, that a request sent twice comes
   back with the same bits, and that 4 responses, and a batch of 32 run at
   once, agree with the same requests run alone at bucket 1: images within
   0.02 (3 uint8 steps), points within 0.016 (two bf16 steps); and that
   each bucket's batch through the kernels agrees with the same batch
   through the plain versions (images 0.02, current points 1e-4, future
   points 0.016). It prints requests/s, frames/s, latency p50/p95, mean
   batch rows and pad fraction both ways, where the dispatcher's and the
   handlers' host time goes (npz and GIF encoding apart from the socket
   write), one response's encoding alone, and the batch-32 readback time;
5b. artifact: exports the serving artifact (``eval/export.py``) at
   ``Config()`` in bf16 with phase 3's random weights, bucket 1 traced on
   the card and bucket 32 on the CPU, and prints each file's bytes and
   export time; loads each, once written, in a fresh spawned process that
   imports the loader and the engine only (it checks that no model, config,
   checkpoint or JAX module was imported) and runs each bucket's batch through
   ``ArtifactEngine``: launches 8 / 1 / 2 / 1 / 2 / 28 per batch, and the outputs
   against ``InferenceEngine.run`` on the same batch (uint8 within one step,
   points within 1e-5; it says whether the bits are the same); times the
   batch-32 generate of the CPU-traced artifact against the live one, host
   loop and device time, in turns (live, artifact, artifact, live); it
   starts ``python -m kpvid_tpu_torch.serve --artifact`` on a free port
   once the CPU-traced file is written, and then
   sends it 16 requests from a spawned client process, and checks
   ``/healthz`` and every npz, and response 0 against ``InferenceEngine``;
6. label: writes a synthetic Penn-Action tree (32 videos, about 1,400
   frames), saves the stage-1 parameters with ``save_parameters`` and runs
   ``python -m kpvid_tpu_torch.make_pseudo_labels``'s ``main`` on the card
   at 128-frame chunks in bf16. It checks one finite [n, 40, 2] label file
   in [-1, 1] per video, one ``pose_head`` launch per chunk and nothing
   else, and on the first 128-frame chunk that the kernel agrees with the
   plain soft-argmax on the same raw maps within 1e-5 and that the labels
   are the kernel's points; it prints frames/s and the host decode's share;
7. stage 1: the backward kernels of #3 (raw maps [32, 128^2, 40]) and #4
   (points [16, 40, 2] from [16, 32^2, 40] maps) against the plain versions'
   torch autograd, f32 and bf16 (f32 within 1e-5 of each tensor's max; bf16
   maps' gradients within one bf16 step or that bound; the points' gradient
   from bf16 cotangents within 1e-4 of its max), the same bits twice, the
   same checks at one image or frame and at 33, 30^2, K = 40 and K = 6 (the
   element-wise path), and their times both ways with bound, plain and the
   launch floor (empty kernels in the same graph measurement), #3's also
   after a 64 MB write between launches and beside ``zero_()`` of the same
   bytes; then ``python -m
   kpvid_tpu_torch.train --mode detector_translator``'s ``main`` at
   ``Config()`` in bf16, batch 16, on phase 6's tree with synthesized VGG19
   weights for 40 fused steps (a checkpoint at step 20, one test sweep, one
   summary write). It checks the launches (1 / 2 forward and 1 / 2 backward
   #3 / #4 a fused step, no #1 / #2; 'fused_dg' and 'two_batch' add one #3
   and two #4 forwards), that every loss is finite and every parameter
   moved, the pose encoder's included (the image encoder's last octave,
   which stage 1 does not read, stays), that a second run resumed from
   ``ckpt-20`` ends with the same bits in every array (with what cuDNN's
   free and deterministic algorithms do to two gradient passes from one
   state), 3 steps each of 'fused_dg' and 'two_batch', and one f32 step at
   ``Config()`` widths, batch 2, on the card and on the CPU (losses rtol
   1e-4, each gradient tensor within 5% in relative L2; it prints each
   tensor's worst element against its max, and the card against itself with
   the source frame one ulp off, since the step's gradient is not continuous
   in its inputs); it prints the step time
   (median of 10), examples/s, peak memory and one step's device time and
   kernel count (``torch.profiler``). Then the labeler runs again with the
   stage-1 trainer's newest checkpoint and rewrites every label file;
8. train: stage 2 at ``Config()`` in bf16, batch 16, on phase 6's tree and
   the labels the port's own stage-1 checkpoint wrote: ``python -m
   kpvid_tpu_torch.train``'s ``main`` for 40 steps (a checkpoint at step 20,
   one test sweep, one summary-image write), then 3 steps each of
   'fused_dg' and 'two_batch'. It checks that every loss is finite, every
   parameter moved and no kernel was launched (stage 2 has none); resumes a
   second run from the step-20 checkpoint to step 40 and checks that it ends
   with the same bits (parameters and Adam state); runs one fused step in
   f32 at ``Config()`` width on the card and on the CPU from the same
   parameters, batch and noise and holds the losses (rtol 1e-4) and every
   gradient (max |card - CPU| <= 1e-3 of the tensor's max |CPU|) against
   each other; and prints the step time (host clock, synchronised, median
   of 10 after warm-up), examples/s, and one step's device time and kernel
   count from ``torch.profiler``;
9. evaluate: ``python -m kpvid_tpu_torch.evaluate``'s ``main`` on the tree's
   8 test videos at eval batch 8, with phase 7's stage-1 checkpoint directory
   (its newest ``ckpt-N``) and phase 8's ``ckpt-40`` directory. It checks
   the PNG tree (2 PNGs and 5 directories of 32 PNGs per sample), 8 / 2 / 1
   / 4 launches per batch (the
   render twice more, for the point images at 128^2), the render at those
   shapes against its plain version (f32 grid into f32 maps, bf16 grid into
   bf16 and f32 maps) and its times, and that a second run with the same
   seed writes the same bytes; it prints samples/s with generate and PNG
   writing timed apart;
10. dp: data parallelism (``kpvid_tpu_torch/parallel``) at ``Config()``,
   global batch 16. (a) ``train.main`` of each stage for 3 steps in one
   process, then through the KPVID_* contract at world size 1 on NCCL in
   this process: with the f32 all-reduce the same bits in every array of
   ``ckpt-3`` and the same launches (stage 1: 1 / 2 forward and 1 / 2
   backward #3 / #4 a step), with the bf16 one every loss finite; one step
   of the data-parallel trainer with the bf16 all-reduce within 2.05 lr of
   the f32 one and not its bits; both steps timed (median of 5) beside
   phases 7 and 8's; (e) the collectives of one step (``torch.profiler``,
   ``parallel.collective_inventory``): counts and bytes, f32 against bf16,
   the bf16 bucket saving 2 bytes a parameter. (c) grad_accum 2: stage 2 in
   f32 against K = 1 (parameters within 1e-5, or 2 lr where the first-step
   gradient is below 1e-6: a sign step); stage 1 in bf16 launches #3 / #4
   forward and backward K times a step; peak memory at K = 1 and 2. (b) two
   ranks (``chip_smoke.py --dp-rank-worker``) sharing the card over gloo,
   each one f32 step (TF32 off) on its 8 rows, against one process at 16:
   both replicas the same bits, losses within rtol 1e-4; stage 2's
   parameters within 1e-5 (the same sign-step rule); stage 1's gradients
   each within 5% relative L2 (phase 7's bound); whether gloo sums bf16 on
   the card and on the host. (d) the labeler on those two ranks (a stride of
   the videos each) within 1e-5 of the one-process labels of the same
   checkpoint, one #3 a chunk; evaluate on the two ranks at batch 4 (one
   batch each, 8 / 1 / 2 / 1 / 4 / 28 launches) writes the one-process tree byte
   for byte. Phase 11's two TF1 imports run beside the ranks;
11. interop: (a) both stages' trainer weights at ``Config()`` from seed 0
   (the generators with phase 3's randomized parameters, the stage-2
   encoder and both discriminators the trainers' init), named and laid out
   as the reference's TF1 checkpoints and written as two TF bundles by
   ``write_tf_bundle`` below; ``python -m
   kpvid_tpu_torch.import_tf1_checkpoint`` of each in a process of its own
   with TensorFlow unimportable (stage 2 at ``--step 1000``): every mapped
   tensor matched, none missing or mismatched; ``FinalGenerator`` on the two
   imported checkpoints gives the bits of the seed-0 parameters loaded
   directly, with 8 / 1 / 2 / 1 / 2 / 28 launches; 3 stage-2 steps of ``train.main``
   from the imported ``ckpt-1000`` with finite losses, the first update at
   ``lr(0)``. (b) 16 stage-1 steps of ``train.main`` with
   ``data.decode_cache_mb`` 256, ``--profile-dir`` and (where
   ``torch.utils.tensorboard`` imports) ``--tensorboard``, and the same 16
   without them: the same bits in every array, 1 / 2 forward and 1 / 2
   backward #3 / #4 a step; the trace of steps 10-14 holds the four
   keypoint kernels. It prints the import seconds and bundle bytes, the
   cache's hits, misses and bytes, both 16-step walls, and the host's
   seconds per sample without the cache and with it over two blocks of
   fresh draws;
12. tp_mesh: (a) tensor parallelism, two ranks (``chip_smoke.py
   --tp-rank-worker``) sharing the card over gloo as a 1x2 mesh, one f32 step
   of each stage at ``Config()`` on the same 16 rows against one process:
   losses within rtol 1e-4, stage 2's parameters within 1e-5 (2.05 lr on
   sign steps, where |g| is below 1e-5 of its tensor's max) and its
   gradients within 1e-3 of each tensor's max, stage 1's gradients within
   5% relative L2; both ranks hold the
   same gathered bits and disjoint halves of the sharded arrays (parameters
   and Adam moments) that join to the single-process layout; per rank the
   launches (1 / 2 forward and 1 / 2 backward #3 / #4 in stage 1), the step
   time against one process, the collectives of a step and the parameter and
   Adam bytes; (b) ``train.main`` of stage 2 at ``--mesh-model 2`` for 3
   steps, its full ``ckpt-3`` resumed in one process; (c) one process over
   several replicas: the engine at batch 32 over the one device and over
   the default device list (the bits of generate on the default stream)
   and over two replicas on the card (each replica's rows generate's bits
   at batch 16, the whole within the bucket bounds of batch 32), 8 / 2 / 1
   / 2 launches per replica batch, timed; ``python -m
   kpvid_tpu_torch.bench`` with and without ``--mesh`` (and over two
   replicas); evaluate's launch over two
   replicas returns to the host in under half a spin queued first on
   replica 0's stream, with that stream still busy (at 4 future frames,
   which keep the launches behind the spin within a stream's queue; it
   prints the device operations one replica queues at 4 and at 32 frames
   and the host's time for 500 and 1,500 launches behind a spin);
   ``serve --mesh`` starts in a process of its own, and while it warms up
   ``evaluate --mesh`` writes phase 9's tree byte for byte, and over two
   replicas the same tree with each replica's point images written after a
   spin kernel on its stream as without; then the daemon answers 16
   requests;
13. multistep: ``train_step_multi`` of both trainers, one step captured as
   a CUDA graph and replayed K times. At ``Config()``, f32, batch 16, K = 3,
   from one state against 3 eager ``train_step``s: stage 2's losses rtol
   1e-5 and parameters within 1e-5 (2.05 lr where the first |g| is below
   1e-5 of its tensor's max: capturable Adam's f32 bias correction against
   the eager one's f64, turned over by a sign step); stage 1's first losses
   rtol 1e-5, later ones 1e-4, parameters within JAX's multi envelope (3 lr
   a step), BN statistics 1e-5. The same graph run again from the same
   state gives the same bits; after a call the step is K and Adam's step
   count a host tensor, and ``state_arrays`` in a fresh trainer steps on to
   the original's bits; ``load_state_arrays`` drops the graph and the next
   call recaptures it; one replay (``torch.profiler``) launches #3 once, #4
   twice, #3' once and #4' twice in stage 1, none of them in stage 2. In
   bf16 at batch 16 the eager step and the graphed one at K = 1, 4 and 16:
   ms a step (host clock), device ms a step (at K = 1 and 4), capture
   seconds, peak memory. Then ``python -m kpvid_tpu_torch.bench_train
   --iters 2 --k 4`` (its JSON line),
   ``bench_host_pipeline --batches 4`` on the card's host, and
   ``verify_reference_parity`` on phase 11's two TF1 bundles over phase 6's
   tree: its renders are the evaluate tree of phase 11's imports byte for
   byte, and against that tree it passes at 0.000 dB;
14. learn: ``train.main`` of stage 1 on ``kpvid_tpu_torch/configs/penn_synth.yaml``
   (``Config()`` widths, bf16, batch 16) and its ``--synthetic`` tree for
   250 steps, as ``--quality`` runs it, with a test sweep after step 0 and
   after step 250: 1 / 2 forward and 1 / 2 backward #3 / #4 a step and one
   forward a sweep, and the test PSNR rises by at least 1.0 dB (the
   ``--quality`` run's rise by then was 1.748 dB);
15. prng: the port's JAX streams (``kpvid_tpu_torch/utils/jax_random.py``)
   on the card's host against JAX's answers recorded in
   ``tests/data/jax_random_kat.json`` (a CPU test writes it with JAX and
   holds it to JAX): keys, splits, fold-ins, bits and uniforms bit for bit,
   normals within 4 ulp with at least 90% of them equal, evaluate's latents
   of batches 0 and 1 at seed 3 within 4 ulp, and Random123's published
   threefry2x32_20 vectors. Then ``init_parameters`` of ``FinalGenerator``
   and of both trainers at ``Config()`` width, each timed, their trees'
   keys those of the file: every leaf's float64 sum (``leaf_sum``, in
   Flax's layout) equal to JAX's, exactly for Xavier, zero and one leaves,
   within 1e-6 relative for the normal(0.02) head.

    python3 chip_smoke.py --quality

runs only the training chain, each CLI in a process of its own on the card:
``python -m kpvid_tpu_torch.train --mode detector_translator --synthetic``
on a copy of ``penn_synth.yaml`` whose paths lie in a temporary directory
and whose ``test_interval`` is 250, for 2,250 steps; the labeler on its
checkpoint; stage 2 on those labels for 2,000 steps; evaluate. It prints
each stage's wall seconds and every sweep's test PSNR and reconstruction
(stage 1) and test KL and reconstruction (stage 2), and holds the curves to
JAX's record (docs/PERF.md:566-571): stage 1's test PSNR within 1.5 dB of
JAX's at steps 500, 1,000, 1,500 and 2,250 and at least 22.0 dB at 2,250,
stage 2's test KL at 2,000 at most a tenth of its first sweep's, and
evaluate's whole PNG tree. It takes about 15 minutes on the H100.

It prints the seconds since the start at each phase. It exits non-zero on
any failed check, and without a CUDA device. The line
before the last holds the kernels' JSON record (launches per generate, per
served batch, per labeled chunk, per stage-1 and stage-2 train step and per
evaluate batch, per artifact batch, per rank of a data-parallel stage-1 step,
per stage-1 step at grad_accum 2, per generate from the imported checkpoints,
per stage-1 step with the frame cache, per rank of a 1x2 tensor-parallel
stage-1 step, per replica batch of the mesh engine, per replay of the
graphed stage-1 step and per step of the learn phase; the backward kernels'
``launches`` are per stage-1 step),
the last line the device.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_TOL = 0.02
BATCH = 4
BATCH_B32 = 32
SLICE_TOL = 1e-3


class CheckFailed(Exception):
    pass


T_START = time.perf_counter()


def check(cond: bool, msg: str) -> None:
    """Raise CheckFailed with ``msg`` unless ``cond``; else print it with the
    seconds since the process started."""
    if not cond:
        raise CheckFailed(msg)
    print(f"ok: {msg} [{time.perf_counter() - T_START:.1f} s]", flush=True)


def write_tf_bundle(prefix: str | Path, tensors: dict, big_endian: bool = False) -> int:
    """A TensorFlow V2 tensor bundle ``prefix.index`` + ``prefix.data-00000-of-00001``
    of ``tensors`` (name -> float32, float64, float16, int32 or int64 numpy
    array), as ``tf.train.load_checkpoint`` reads it: the tensors' bytes in
    one shard, and the index a LevelDB table of one data block (the header
    under the key "", then each BundleEntryProto under its name), an empty
    metaindex block and an index block, each with its masked crc32c, and the
    48-byte footer (kpvid_tpu_torch/utils/tf_bundle.py reads the format).
    The package reads bundles and never writes them. ``big_endian`` marks
    the header so (the tensors stay little-endian), for the reader's refusal.
    Returns the bytes written."""
    import struct

    from kpvid_tpu_torch.utils.tf_bundle import TABLE_MAGIC, crc32c, mask_crc

    dtypes = {np.dtype("<f4"): 1, np.dtype("<f8"): 2, np.dtype("<i4"): 3, np.dtype("<i8"): 9,
              np.dtype("<f2"): 19}

    def varint(n: int) -> bytes:
        out = bytearray()
        while n >= 0x80:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        return bytes(out + bytes([n]))

    def f_varint(num: int, v: int) -> bytes:
        return varint(num << 3) + varint(v)

    def f_bytes(num: int, b: bytes) -> bytes:
        return varint(num << 3 | 2) + varint(len(b)) + b

    def block(items: list) -> bytes:
        body = b"".join(varint(0) + varint(len(k)) + varint(len(v)) + k + v for k, v in items)
        return body + struct.pack("<II", 0, 1)  # one restart point, at 0

    def trailer(b: bytes) -> bytes:
        return b"\x00" + struct.pack("<I", mask_crc(crc32c(b + b"\x00")))

    prefix = str(prefix)
    entries, offset = [], 0
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        for name in sorted(tensors):
            a = np.asarray(tensors[name])
            a = a.astype(a.dtype.newbyteorder("<"), order="C")
            raw = a.tobytes()
            shape = b"".join(f_bytes(2, f_varint(1, d)) for d in a.shape)
            entries.append((name.encode(), f_varint(1, dtypes[a.dtype]) + f_bytes(2, shape)
                            + f_varint(4, offset) + f_varint(5, len(raw))
                            + varint(6 << 3 | 5) + struct.pack("<I", mask_crc(crc32c(raw)))))
            f.write(raw)
            offset += len(raw)
    # one shard, the endianness, version producer 1
    header = f_varint(1, 1) + f_varint(2, int(big_endian)) + f_bytes(3, f_varint(1, 1))
    data = block([(b"", header)] + sorted(entries))
    meta = block([])
    meta_at = len(data) + 5
    index_at = meta_at + len(meta) + 5
    index = block([(max(k for k, _ in entries), varint(0) + varint(len(data)))])
    handles = varint(meta_at) + varint(len(meta)) + varint(index_at) + varint(len(index))
    table = (data + trailer(data) + meta + trailer(meta) + index + trailer(index)
             + handles.ljust(40, b"\x00") + struct.pack("<Q", TABLE_MAGIC))
    Path(prefix + ".index").write_bytes(table)
    return offset + len(table)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, budget_s: float = 0.3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(max(budget_s / max(time.perf_counter() - t0, 1e-6), 3), 200))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 10, budget_s: float = 0.3) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, the graph replayed back to back between two CUDA events, so the
    host's launch cost is paid once a replay and hidden behind the device's
    work. What is left of the host is the graph's gap between its kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture: builds, caches, attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    n = int(min(max(budget_s / max(time.perf_counter() - t0, 1e-6), 3), 200))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    return ms


# the kernels' symbols in a profiler trace, by wrapper (#1 and #2 share theirs)
KERNEL_SYMBOLS = {"conv3x3": "conv3x3_", "pose_head": "pose_head_kernel",
                  "gaussian_render": "gaussian_render_kernel",
                  "pose_head_backward": "pose_head_backward_kernel",
                  "gaussian_render_backward": "render_backward_kernel",
                  "bias_bn_relu": "bias_bn_relu_", "lstm_cell": "lstm_cell_kernel"}


REPLAY_SYMBOL = {"conv3x3_affine": "conv3x3", "conv3x3_add_affine": "conv3x3",
                 "up2_conv3_affine": "conv3x3"}


def replay_kernels(graph) -> dict:
    """One replay of a captured CUDA graph under ``torch.profiler``: the
    device operations it ran, their device ms, and each kernel's launches
    (the wrappers' counters count the capture, not the replays)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    ops = device_records(prof)
    return {"kernels": sum(n for _, n, _ in ops),
            "device_ms": sum(us for _, _, us in ops) / 1e3,
            "launches": {name: sum(n for key, n, _ in ops if sym in key)
                         for name, sym in KERNEL_SYMBOLS.items()}}


def device_records(prof) -> list:
    """(name, count, µs) of each device operation a finished
    ``torch.profiler.profile`` recorded, from its raw records
    (``bench_train.profile_totals``)."""
    from kpvid_tpu_torch.bench_train import profile_totals

    device, _ = profile_totals(prof)
    return [(name, n, us) for name, (n, us) in device.items()]


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if dtype == torch.float32:
        ok = bool(torch.allclose(got, want, **F32_TOL))
    else:
        ok = err <= BF16_REL_TOL * float(want.abs().max())
    if not ok:
        raise CheckFailed(f"kernel disagrees with its plain version: max abs err {err}")
    return err


def compare_one_bf16_step(got, want) -> float:
    """bf16 outputs that round the same f32 value once: each within one bf16
    step of the larger magnitude (2^-7 of it)."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool((err <= 2.0**-7 * torch.maximum(g.abs(), w.abs()) + 2.0**-126).all()):
        raise CheckFailed(f"bf16 maps more than one bf16 step from plain: max abs err "
                          f"{float(err.max())}")
    return float(err.max())


def conv_shapes(m, n: int) -> tuple[list, list]:
    """The cases of #1 and of #2 that ``generate`` launches at N frames:
    (label, input shape, Cout, relu, launches per generate)."""
    hs, s = m.heatmap_size, m.image_size
    f0 = m.translator_filters
    f1, f2 = f0 // 2, f0 // 4
    conv = [
        ("oct0 b/c/d", (n, hs, hs, f0), f0, True, 3),
        ("oct1 b/c/d", (n, 2 * hs, 2 * hs, f1), f1, True, 3),
        ("oct2b", (n, s, s, f2), f2, True, 1),
        ("heads", (n, s, s, f2), 4, False, 1),
    ]
    up2 = [
        ("oct1a", (n, hs, hs, f0), f1, True, 1),
        ("oct2a", (n, 2 * hs, 2 * hs, f1), f2, True, 1),
    ]
    return conv, up2


def check_add_conv(gen, m, b: int, timed: bool = True) -> tuple[dict, dict]:
    """#1+ as ``generate`` launches it for ``b`` samples: the split first
    conv's per-frame part ([b * T, hs, hs, K] -> translator_filters, an f32
    addend row a sample) with oct0a's affine and ReLU, f32 and bf16 against
    the plain version; then the bf16 call's device time and, when ``timed``,
    its host loop, the plain version's and the route it replaced (cuDNN's
    conv, the broadcast add, the f32 affine and ReLU; device time).
    Returns (max abs error by dtype, times)."""
    import torch
    import torch.nn.functional as F

    from kpvid_tpu_torch import ops

    t, hs, c, cout = m.n_future_frames, m.heatmap_size, m.n_pts, m.translator_filters
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, k, sc, sh = conv_inputs(gen, (b * t, hs, hs, c), cout, dtype)
        add = torch.randn((b, hs, hs, cout), generator=gen, device="cuda")
        got = ops.conv3x3_add_affine(x, k, add, sc, sh)
        torch.cuda.synchronize()
        errs[dtype] = compare(got, ops.conv3x3_add_affine_plain(x, k, add, sc, sh), dtype)
        del got
    # x, k, add, sc, sh are the bfloat16 inputs of the path

    def kernel():
        return ops.conv3x3_add_affine(x, k, add, sc, sh)

    times = {"ms": device_ms(kernel)}
    n_ops = 2.0 * b * t * hs * hs * cout * 9 * c
    n_bytes = (2.0 * (b * t * hs * hs * (c + cout) + 9 * c * cout) + 8 * cout
               + 4.0 * b * hs * hs * cout)
    times["bound_ms"], times["bound_by"] = bound_ms(n_bytes, n_ops, "bfloat16")
    if timed:
        wc = k.permute(3, 2, 0, 1).contiguous()

        def former():
            y = F.conv2d(x.permute(0, 3, 1, 2), wc, padding=1).permute(0, 2, 3, 1)
            y = (y.unflatten(0, (b, t)) + add.to(x.dtype)[:, None]).flatten(0, 1)
            return torch.relu(y.float() * sc + sh).to(x.dtype)

        times.update(host_loop_ms=time_ms(kernel), former_route_ms=device_ms(former),
                     plain_ms=time_ms(lambda: ops.conv3x3_add_affine_plain(x, k, add, sc, sh)))
    return errs, times


def conv_inputs(gen, shape, cout, dtype):
    import torch

    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, c, cout), generator=gen, device="cuda") / (3 * c**0.5)).to(dtype)
    sc = torch.rand(cout, generator=gen, device="cuda") + 0.5
    sh = torch.randn(cout, generator=gen, device="cuda") * 0.1
    return x, k, sc, sh


def check_pose_head(gen, m, b: int) -> tuple[dict, object]:
    """#3 on [b, S, S, K] maps, f32 and bf16, against the plain soft-argmax;
    returns the errors by dtype and the bf16 maps (the main path's input)."""
    import torch

    from kpvid_tpu_torch import ops

    s, k_pts = m.image_size, m.n_pts
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        raw = (3 * torch.randn((b, s, s, k_pts), generator=gen, device="cuda")).to(dtype)
        got = ops.pose_head(raw)
        torch.cuda.synchronize()
        errs[dtype] = compare(got, ops.heatmaps_to_keypoints(raw), torch.float32)
        print(f"pose_head {tuple(raw.shape)} {dtype}: max abs err {errs[dtype]:.3e}", flush=True)
    return errs, raw


def check_render(gen, m, rows: int, gd, hs: int | None = None) -> tuple[dict, object]:
    """#4 from [rows, K, 2] points on the ``gd`` grid, into f32 and bf16
    [rows, hs, hs, K] maps (hs: the heatmap size unless given), against the
    plain render; returns the errors by output dtype and the points."""
    import torch

    from kpvid_tpu_torch import ops

    hs = hs or m.heatmap_size
    mu = (torch.rand((rows, m.n_pts, 2), generator=gen, device="cuda") * 2 - 1).to(gd).float()
    errs = {}
    for od in (torch.float32, torch.bfloat16):
        got = ops.gaussian_render(mu, hs, hs, m.heatmap_inv_std, gd, od)
        torch.cuda.synchronize()
        want = ops.render_gaussian_maps(mu, hs, hs, m.heatmap_inv_std, gd, od)
        if od == torch.float32:
            errs[od] = compare(got, want, torch.float32)
        else:
            errs[od] = compare_one_bf16_step(got, want)
        print(f"gaussian_render {tuple(mu.shape)} {gd} grid -> {od}: max abs err "
              f"{errs[od]:.3e}", flush=True)
    return errs, mu


def bn_layer_shapes(cfg) -> list:
    """The [H, W, C] of each ``bias_bn_relu`` call of a generate, in launch
    order: detect's (the pose encoder's trunk and
    decoder), then embed's (the image trunk through its second octave);
    recorded from one sample's pass through ``Stage1Generator`` on the card."""
    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.eval import FinalGenerator

    stage1 = FinalGenerator(cfg).stage1
    shapes = []

    def record(y, *args):
        shapes.append(tuple(y.shape[1:]))
        return ops.bias_bn_relu(y, *args)

    s = cfg.model.image_size
    im = torch.zeros((1, s, s, 3), device="cuda")
    with torch.no_grad(), mock.patch("kpvid_tpu_torch.models.layers.bias_bn_relu", record):
        stage1.detect(im)
        stage1.embed(im)
    check(len(shapes) == EXPECTED_LAUNCHES["bias_bn_relu"],
          f"a generate's bias + BN + ReLU layers: {len(shapes)}")
    return shapes


def bn_inputs(gen, shape, dtype):
    """(y, conv_bias, mean, mul, beta) of ``bias_bn_relu`` on the card: a
    conv output of scale 3 in ``dtype``, NaN every 97th element, the conv
    bias in ``dtype`` and the f32 vectors of a BN with random statistics."""
    import torch

    c = shape[-1]
    y = torch.randn(shape, generator=gen, device="cuda") * 3
    y.view(-1)[::97] = float("nan")
    conv_bias, mean, beta = (torch.randn(c, generator=gen, device="cuda") * 0.3 for _ in range(3))
    var = torch.rand(c, generator=gen, device="cuda") * 1.8 + 0.2
    mul = torch.randn(c, generator=gen, device="cuda") * torch.rsqrt(var + 1e-5)
    return y.to(dtype), conv_bias.to(dtype), mean, mul, beta


def check_bias_bn_relu(gen, shape, dtype) -> tuple[float, tuple]:
    """``bias_bn_relu`` on ``bn_inputs`` against its plain version on the
    same card tensors: the same bits (NaN payloads and signed zeros count).
    Returns the max abs error over the non-NaN elements (0) and the inputs."""
    import torch

    from kpvid_tpu_torch import ops

    args = bn_inputs(gen, shape, dtype)
    got = ops.bias_bn_relu(*args, True)
    want = ops.bias_bn_relu_plain(*args, True)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    differ = int((got.view(bits) != want.view(bits)).sum())
    if differ or got.stride() != want.stride():
        raise CheckFailed(f"bias_bn_relu {shape} {dtype}: {differ} elements differ from the "
                          f"plain version's bits, strides {got.stride()} / {want.stride()}")
    return float((got.float() - want.float()).nan_to_num().abs().max()), args


# lstm_cell's h and c (f32) against the plain step's: the same bf16
# products, summed in f32 in another order
LSTM_TOL = 1e-5


def lstm_layer_shapes(m) -> list:
    """(input width, hidden units) of each layer of the motion decoder's
    LSTM: dec_in's 32 outputs feed the first."""
    h = [int(f) for f in m.cell_info]
    return list(zip([32] + h[:-1], h))


def lstm_inputs(gen, b: int, d: int, h: int) -> tuple:
    """(x, h, c, kernel, bias) of one LSTM step on the card: x and h in
    (-1, 1) and the kernel of Xavier's scale in bf16, c N(0, 1) and the bias
    N(0, 0.3) in f32."""
    import torch

    bf16 = torch.bfloat16
    x = (torch.rand((b, d), generator=gen, device="cuda") * 2 - 1).to(bf16)
    hid = (torch.rand((b, h), generator=gen, device="cuda") * 2 - 1).to(bf16)
    c = torch.randn((b, h), generator=gen, device="cuda")
    kernel = (torch.randn((d + h, 4 * h), generator=gen, device="cuda")
              * (2.0 / (d + 5 * h)) ** 0.5).to(bf16)
    bias = torch.randn(4 * h, generator=gen, device="cuda") * 0.3
    return x, hid, c, kernel, bias


def check_lstm_cell(gen, m, b: int, timed: bool = True) -> tuple[float, dict]:
    """``lstm_cell`` at each decoder layer's shape at batch ``b`` against its
    plain version on the same card tensors: h and c within LSTM_TOL, the
    bf16 h the rounding of the kernel's f32 h, a second call the same bits.
    Returns the largest error and, ``timed``, the times of a generate's
    launches (n_future_frames a layer): device, host loop, plain, library
    (the route the op replaced: the product of the widened operands and the
    torch cell) and the HBM reference (each launch reads its kernel from
    HBM; an upper reference, not the kernel's roofline, since the kernels
    may stay in L2 from one launch to the next)."""
    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.ops.lstm import cell_update

    t = m.n_future_frames
    err, n_bytes, n_ops = 0.0, 0.0, 0.0
    times = dict(ms=0.0, host_loop_ms=0.0, plain_ms=0.0, library_ms=0.0)
    for d, h in lstm_layer_shapes(m):
        args = lstm_inputs(gen, b, d, h)
        got, again = ops.lstm_cell(*args), ops.lstm_cell(*args)
        want = ops.lstm_cell_plain(*args)
        torch.cuda.synchronize()
        e = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if e > LSTM_TOL or not same or not torch.equal(got[2], got[0].to(torch.bfloat16)):
            raise CheckFailed(f"lstm_cell batch {b}, D {d}, H {h}: max abs err {e} (bound "
                              f"{LSTM_TOL}), the same bits twice: {same}")
        err = max(err, e)
        n_ops += t * 2.0 * b * (d + h) * 4 * h
        n_bytes += t * (2.0 * (d + h) * 4 * h + 16.0 * h + b * (2.0 * d + 16.0 * h))
        if timed:
            wide = args[3].float()

            def library():
                z = torch.cat([args[0], args[1]], dim=-1).float()
                return cell_update(torch.matmul(z, wide) + args[4], args[2])

            times["ms"] += t * device_ms(lambda: ops.lstm_cell(*args))
            times["host_loop_ms"] += t * time_ms(lambda: ops.lstm_cell(*args))
            times["plain_ms"] += t * time_ms(lambda: ops.lstm_cell_plain(*args))
            times["library_ms"] += t * device_ms(library)
    times["bound_ms"], times["bound_by"] = bound_ms(n_bytes, n_ops, "bfloat16")
    return err, times


def kernel_phase(cfg) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from kpvid_tpu_torch import ops

    m = cfg.model
    n = BATCH * m.n_future_frames
    hs, s, k_pts = m.heatmap_size, m.image_size, m.n_pts
    conv_cases, up2_cases = conv_shapes(m, n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}

    for name, kernel, plain, cases, up2 in (
        ("conv3x3_affine", ops.conv3x3_affine, ops.conv3x3_affine_plain, conv_cases, False),
        ("up2_conv3_affine", ops.up2_conv3_affine, ops.up2_conv3_affine_plain, up2_cases, True),
    ):
        rec = dict(ms=0.0, host_loop_ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, bytes=0.0,
                   library_ms=0.0 if not up2 else None, max_abs_err=0.0, max_abs_err_f32=0.0)
        for label, shape, cout, relu, mult in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, k, sc, sh = conv_inputs(gen, shape, cout, dtype)
                got = kernel(x, k, sc, sh, relu=relu)
                torch.cuda.synchronize()
                err = compare(got, plain(x, k, sc, sh, relu=relu), dtype)
                key = "max_abs_err_f32" if dtype == torch.float32 else "max_abs_err"
                rec[key] = max(rec[key], err)
                print(f"{name} {label} {tuple(shape)}->{cout} {dtype}: max abs err {err:.3e}",
                      flush=True)
            # x, k, sc, sh are the bfloat16 inputs of the main path
            t_k = device_ms(lambda: kernel(x, k, sc, sh, relu=relu))
            t_h = time_ms(lambda: kernel(x, k, sc, sh, relu=relu))
            t_p = time_ms(lambda: plain(x, k, sc, sh, relu=relu))
            nb, h, w, c = shape
            oh, ow = (2 * h, 2 * w) if up2 else (h, w)
            n_ops = 2.0 * nb * oh * ow * cout * 9 * c
            n_bytes = 2.0 * (nb * h * w * c + 9 * c * cout + nb * oh * ow * cout) + 8 * cout
            b_ms, _ = bound_ms(n_bytes, n_ops, "bfloat16")
            line = (f"{name} {label} bf16: device {t_k:.4f} ms ({n_ops / t_k / 1e9:.1f} TFLOP/s, "
                    f"{100 * b_ms / t_k:.1f}% of the bound {b_ms:.4f} ms), host loop "
                    f"{t_h:.4f} ms, plain {t_p:.4f} ms")
            if not up2:
                xc = x.permute(0, 3, 1, 2)  # channels_last view
                wc = (k.float() * sc).to(x.dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bias = sh.to(x.dtype)
                t_l = device_ms(lambda: F.conv2d(xc, wc, bias, padding=1))
                rec["library_ms"] += mult * t_l
                line += f", F.conv2d {t_l:.4f} ms, kernel / F.conv2d {t_k / t_l:.2f}"
            else:
                line += ", F.conv2d n/a"
            print(line + f", x{mult} per generate", flush=True)
            rec["ms"] += mult * t_k
            rec["host_loop_ms"] += mult * t_h
            rec["plain_ms"] += mult * t_p
            rec["ops"] += mult * n_ops
            rec["bytes"] += mult * n_bytes
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["ops"], "bfloat16")
        ratio = "n/a" if up2 else f"{rec['ms'] / rec['library_ms']:.2f}"
        print(f"{name} per generate at batch {BATCH} bf16: {rec['ops'] / rec['ms'] / 1e9:.1f} "
              f"TFLOP/s, {100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound, "
              f"kernel / F.conv2d {ratio}", flush=True)
        records[name] = rec

    # #1+: the split first conv with oct0a's BN and ReLU
    rec = dict(library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    for b in (BATCH, BATCH_B32):
        errs, times = check_add_conv(gen, m, b)
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
        if b == BATCH:
            rec.update(times)
        else:
            rec["b32"] = times
        print(f"conv3x3_add_affine bf16 batch {b} ({b * m.n_future_frames} frames): device "
              f"{times['ms']:.4f} ms ({100 * times['bound_ms'] / times['ms']:.1f}% of the bound "
              f"{times['bound_ms']:.4f} ms, {times['bound_by']}), host loop "
              f"{times['host_loop_ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, the route it "
              f"replaced {times['former_route_ms']:.4f} ms; max abs err bf16 "
              f"{errs[torch.bfloat16]:.3e}, f32 {errs[torch.float32]:.3e}", flush=True)
    records["conv3x3_add_affine"] = rec

    # pose head: the raw heatmaps of the request images, which the path
    # hands over in the compute dtype (bf16); f32 is checked too
    rec = dict(library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    for b in (BATCH, BATCH_B32):
        errs, raw = check_pose_head(gen, m, b)
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
        check(torch.equal(ops.pose_head(raw), ops.pose_head(raw)),
              f"pose_head at batch {b} gives the same points twice")
        # raw is the bf16 input of the main path
        n_bytes = raw.numel() * raw.element_size() + 4.0 * b * k_pts * 2
        n_ops = 2.0 * raw.numel() + 6.0 * b * k_pts * 2 * s
        times = dict(ms=device_ms(lambda: ops.pose_head(raw), reps=100),
                     host_loop_ms=time_ms(lambda: ops.pose_head(raw)),
                     plain_ms=time_ms(lambda: ops.heatmaps_to_keypoints(raw)))
        times["bound_ms"], times["bound_by"] = bound_ms(n_bytes, n_ops, "float32")
        if b == BATCH:
            rec.update(times)
        else:
            rec["b32"] = times
        print(f"pose_head bf16 batch {b}: device {times['ms']:.4f} ms "
              f"({100 * times['bound_ms'] / times['ms']:.1f}% of the bound "
              f"{times['bound_ms']:.4f} ms), host loop {times['host_loop_ms']:.4f} ms, plain "
              f"{times['plain_ms']:.4f} ms", flush=True)
    records["pose_head"] = rec

    # gaussian render: the current maps ([B, K, 2], f32 grid) and the future
    # maps ([B*T, K, 2]), whose grid takes the keypoints' dtype; the path
    # writes both in the compute dtype (bf16); f32 maps are checked too
    rec = dict(library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    t = m.n_future_frames
    for b in (BATCH, BATCH_B32):
        times = dict(ms=0.0, host_loop_ms=0.0, plain_ms=0.0)
        tot_bytes = tot_ops = 0.0
        for rows, gd in ((b, torch.float32), (b * t, torch.bfloat16)):
            errs, mu = check_render(gen, m, rows, gd)
            rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
            rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
            # the main path's call: bf16 maps
            args = (mu, hs, hs, m.heatmap_inv_std, gd, torch.bfloat16)
            times["ms"] += device_ms(lambda: ops.gaussian_render(*args), reps=100)
            times["host_loop_ms"] += time_ms(lambda: ops.gaussian_render(*args))
            times["plain_ms"] += time_ms(lambda: ops.render_gaussian_maps(*args))
            tot_bytes += 4.0 * rows * k_pts * 2 + 2.0 * rows * hs * hs * k_pts
            tot_ops += rows * (hs * hs * k_pts + 8.0 * k_pts * 2 * hs)
        times["bound_ms"], times["bound_by"] = bound_ms(tot_bytes, tot_ops, "float32")
        if b == BATCH:
            rec.update(times)
        else:
            rec["b32"] = times
        print(f"gaussian_render bf16 per generate at batch {b}: device {times['ms']:.4f} ms "
              f"({100 * times['bound_ms'] / times['ms']:.1f}% of the bound "
              f"{times['bound_ms']:.4f} ms), host loop {times['host_loop_ms']:.4f} ms, plain "
              f"{times['plain_ms']:.4f} ms", flush=True)
    records["gaussian_render"] = rec

    # the encoders' inference bias + BN + ReLU at each of a generate's 28
    # layer shapes, bit for bit against the plain version; bound: the
    # activation read and written once, the conv bias and 12 bytes a channel
    rec = dict(library_ms=None, max_abs_err=0.0, max_abs_err_f32=0.0)
    layer_shapes = bn_layer_shapes(cfg)
    for b in (BATCH, BATCH_B32):
        times = dict(ms=0.0, host_loop_ms=0.0, plain_ms=0.0)
        n_bytes = 0.0
        for shape in ((b, *hwc) for hwc in layer_shapes):
            for dtype in (torch.float32, torch.bfloat16):
                err, args = check_bias_bn_relu(gen, shape, dtype)
                key = "max_abs_err_f32" if dtype == torch.float32 else "max_abs_err"
                rec[key] = max(rec[key], err)
            # args are the bfloat16 inputs of the path
            times["ms"] += device_ms(lambda: ops.bias_bn_relu(*args, True))
            times["host_loop_ms"] += time_ms(lambda: ops.bias_bn_relu(*args, True))
            times["plain_ms"] += time_ms(lambda: ops.bias_bn_relu_plain(*args, True))
            n_bytes += 2.0 * (2 * args[0].numel() + shape[-1]) + 12.0 * shape[-1]
            del args
        times["bound_ms"], times["bound_by"] = bound_ms(n_bytes, 0.0, "float32")
        if b == BATCH:
            rec.update(times)
        else:
            rec["b32"] = times
        print(f"bias_bn_relu bf16 per generate at batch {b} (28 layers, bits of the plain "
              f"version in f32 and bf16): device {times['ms']:.4f} ms "
              f"({100 * times['bound_ms'] / times['ms']:.1f}% of the bound "
              f"{times['bound_ms']:.4f} ms), host loop {times['host_loop_ms']:.4f} ms, plain "
              f"{times['plain_ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    records["bias_bn_relu"] = rec

    # the motion decode's LSTM step at each layer's shape, n_future_frames
    # launches a layer a generate; bf16 only (f32 keeps the torch route)
    rec = dict(max_abs_err=0.0, max_abs_err_f32=None)
    for b in (BATCH, BATCH_B32):
        err, times = check_lstm_cell(gen, m, b)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if b == BATCH:
            rec.update(times)
        else:
            rec["b32"] = times
        print(f"lstm_cell bf16 per generate at batch {b} ({2 * m.n_future_frames} launches, "
              f"max abs err {err:.3e}): device {times['ms']:.4f} ms "
              f"({100 * times['bound_ms'] / times['ms']:.1f}% of the HBM reference "
              f"{times['bound_ms']:.4f} ms, {times['bound_by']}), host loop "
              f"{times['host_loop_ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, the route it "
              f"replaced {times['library_ms']:.4f} ms (device)", flush=True)
    records["lstm_cell"] = rec
    for name, r in records.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name} per generate at batch {BATCH}: device {r['ms']:.4f} ms, host loop "
              f"{r['host_loop_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return records


def bucket_kernel_phase(cfg) -> dict:
    """Every kernel against its plain version, f32 and bf16, at the shapes
    each of the daemon's buckets gives it (N = bucket * 32 frames), with the
    tolerances of ``kernel_phase`` (bias_bn_relu: the same bits; lstm_cell
    bf16 only, within LSTM_TOL); returns
    the worst error per kernel and bucket, and the device ms of #1 and #2 per
    generate at each bucket (bf16, the launches of one generate)."""
    import torch

    from kpvid_tpu_torch import ops

    m = cfg.model
    gen = torch.Generator(device="cuda").manual_seed(1)
    layer_shapes = bn_layer_shapes(cfg)
    worst = {}
    for b in SERVE_BUCKETS:
        conv_cases, up2_cases = conv_shapes(m, b * m.n_future_frames)
        errs, conv_ms = {}, {}
        for name, kernel, plain, cases in (
            ("conv3x3_affine", ops.conv3x3_affine, ops.conv3x3_affine_plain, conv_cases),
            ("up2_conv3_affine", ops.up2_conv3_affine, ops.up2_conv3_affine_plain, up2_cases),
        ):
            conv_ms[name] = 0.0
            for _, shape, cout, relu, mult in cases:
                for dtype in (torch.float32, torch.bfloat16):
                    x, k, sc, sh = conv_inputs(gen, shape, cout, dtype)
                    got = kernel(x, k, sc, sh, relu=relu)
                    err = compare(got, plain(x, k, sc, sh, relu=relu), dtype)
                    errs[name] = max(errs.get(name, 0.0), err)
                    del got
                # x, k, sc, sh are the bfloat16 inputs of the path
                conv_ms[name] += mult * device_ms(lambda: kernel(x, k, sc, sh, relu=relu))
                del x
        add_errs, add_times = check_add_conv(gen, m, b, timed=False)
        errs["conv3x3_add_affine"] = max(add_errs.values())
        conv_ms["conv3x3_add_affine"] = add_times["ms"]
        errs["pose_head"] = max(check_pose_head(gen, m, b)[0].values())
        errs["gaussian_render"] = max(
            max(check_render(gen, m, rows, gd)[0].values())
            for rows, gd in ((b, torch.float32), (b * m.n_future_frames, torch.bfloat16)))
        errs["bias_bn_relu"] = max(check_bias_bn_relu(gen, shape, dtype)[0]
                                   for shape in ((b, *hwc) for hwc in layer_shapes)
                                   for dtype in (torch.float32, torch.bfloat16))
        errs["lstm_cell"] = check_lstm_cell(gen, m, b, timed=False)[0]
        torch.cuda.empty_cache()
        worst[b] = errs
        check(True, f"bucket {b} (N = {b * m.n_future_frames}): every kernel agrees with its "
                    f"plain version, f32 and bf16; worst max abs err "
                    + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                    + "; device ms per generate, bf16: "
                    + ", ".join(f"{n} {t:.4f}" for n, t in conv_ms.items()))
        errs["device_ms"] = conv_ms
    return worst


def sass_phase() -> None:
    """Every bf16 conv kernel of the built library runs on the tensor cores:
    its SASS holds HGMMA (wgmma) or HMMA (mma.sync) instructions."""
    from kpvid_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump found")
    lib = _build._target("conv3x3.cu")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(maxsplit=1)[0]
        if "bf16_mma_kernel" in name:
            found[name] = next((op for op in ("HGMMA", "HMMA") if op in section), None)
    print(f"bf16 conv kernels in {lib.name}: " + ", ".join(
        f"{name[:60]}...: {op}" for name, op in found.items()), flush=True)
    check(bool(found) and all(found.values()),
          f"all {len(found)} bf16 conv kernels hold {sorted(set(found.values()) - {None})}")


def randomized_params(cfg, seed: int) -> dict:
    """init_parameters(seed) (JAX's init_variables(PRNGKey(seed))) with the BN
    statistics, BN affine and biases drawn at random too, so that a mistake in
    any of them shows."""
    import torch

    from kpvid_tpu_torch.eval import FinalGenerator

    params = FinalGenerator(cfg, device="cpu").init_parameters(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for key, val in params.items():
        if key.endswith("running_var"):
            val.uniform_(0.5, 2.0, generator=gen)
        elif key.endswith(".bn.weight"):
            val.uniform_(0.5, 1.5, generator=gen)
        elif key.endswith(("running_mean", "bias")):
            val.normal_(0.0, 0.1, generator=gen)
    return params


# a generate: #1 / #1+ / #2 / #3 / #4, the inference bias + BN + ReLU of
# the image trunk's 6 layers that embed runs, the pose trunk's 8 and the pose
# decoder's 14, and the motion decode's LSTM step, one a step and layer
# (2 x 32)
EXPECTED_LAUNCHES = {"conv3x3_affine": 8, "conv3x3_add_affine": 1, "up2_conv3_affine": 2,
                     "pose_head": 1, "gaussian_render": 2, "pose_head_backward": 0,
                     "gaussian_render_backward": 0, "bias_bn_relu": 28, "lstm_cell": 64}


NO_LAUNCHES = {name: 0 for name in EXPECTED_LAUNCHES}


@contextlib.contextmanager
def decode_paths():
    """Counts the motion decode's calls by path (eval/final.py::GraphedDecode's
    ``captures``, ``replays`` and ``eager_calls``) over every generator that
    decodes inside the block, in any thread."""
    from kpvid_tpu_torch.eval.final import GraphedDecode

    tally = dict(captures=0, replays=0, eager_calls=0)
    lock = threading.Lock()
    call = GraphedDecode.__call__

    def counted(self, *args):
        before = {k: getattr(self, k) for k in tally}
        try:
            return call(self, *args)
        finally:
            with lock:
                for k in tally:
                    tally[k] += getattr(self, k) - before[k]

    with mock.patch.object(GraphedDecode, "__call__", counted):
        yield tally


def generate_launches(paths: dict, generates: int, per: dict = EXPECTED_LAUNCHES) -> dict:
    """What the wrappers count over ``generates`` generates whose motion
    decodes took ``paths`` (decode_paths): ``per``'s launches outside the
    decode once a generate, and lstm_cell's once for each decode that ran
    eager and twice for each capture (its eager warm-up and the launches
    captured into the graph). A replay's kernels run on the device alone,
    and only the profiler counts them (replay_kernels)."""
    return dict({k: v * generates for k, v in per.items()},
                lstm_cell=per["lstm_cell"] * (paths["eager_calls"] + 2 * paths["captures"]))
# a detect (a labeling chunk): #3 and the pose encoder's 22 bias + BN + ReLU
DETECT_LAUNCHES = dict(NO_LAUNCHES, pose_head=1, bias_bn_relu=22)
# a stage-1 forward with inference BN (a test sweep's batch, a summary): the
# bias + BN + ReLU of the whole image trunk (8), the pose encoder on the
# pair batch (22) and the translator's training form (10)
S1_INFERENCE_BN = 40


def per_chunk(launches: dict, chunks: int) -> dict:
    return {name: c * chunks for name, c in launches.items()}


def slice_phase(cfg, params) -> dict:
    """4 requests through InferenceEngine; returns the launch counts of one run."""
    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.eval import InferenceEngine, request_z

    m = cfg.model
    engine = InferenceEngine(cfg, params, device="cuda")
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (BATCH, m.image_size, m.image_size, 3)).astype(np.float32)
    actions = np.array([0, 3, 5, 8]) % m.n_action
    z = np.stack([request_z(seed, m.vae_dim) for seed in (11, 12, 13, 14)])

    with decode_paths() as paths:
        ops.reset_launch_counts()
        engine.run(images, actions, z)
        first = ops.launch_counts()
    check(paths == dict(captures=1, replays=1, eager_calls=0)
          and first == generate_launches(paths, 1),
          f"the first generate captures the decode's graph: launches {first} are "
          "8 / 1 / 2 / 1 / 2 / 28 and lstm_cell's 64 twice (the warm-up and the capture)")
    # a generate that replays the graph: the wrappers count the kernels
    # outside it, one replay under the profiler the graph's
    with decode_paths() as paths:
        ops.reset_launch_counts()
        out = engine.run(images, actions, z)
        counts = ops.launch_counts()
    graphs = engine.final.model.motion_decode.graphs
    replayed = replay_kernels(next(iter(graphs.values()))[0])["launches"]
    print(f"launches in one generate: {counts} from the wrappers, {replayed} from the decode's "
          "replay", flush=True)
    counts = {name: n + replayed.get(name, 0) for name, n in counts.items()}
    check(paths == dict(captures=0, replays=1, eager_calls=0) and len(graphs) == 1
          and counts == EXPECTED_LAUNCHES
          and replayed == dict({name: 0 for name in KERNEL_SYMBOLS},
                               lstm_cell=EXPECTED_LAUNCHES["lstm_cell"]),
          "launches per generate are 8 / 1 / 2 / 1 / 2 / 28 / 64, the 64 lstm_cell in the "
          "decode's replay")
    t, s, k = m.n_future_frames, m.image_size, m.n_pts
    check(out["pred_im_seq"].shape == (BATCH, t, s, s, 3) and out["pred_im_seq"].dtype == np.uint8,
          f"pred_im_seq is uint8 {out['pred_im_seq'].shape}")
    check(out["mask"].shape == (BATCH, t, s, s, 1) and out["mask"].dtype == np.uint8,
          f"mask is uint8 {out['mask'].shape}")
    check(out["current_points"].shape == (BATCH, k, 2)
          and np.isfinite(out["current_points"]).all(), "current_points finite [B, K, 2]")
    check(out["future_points"].shape == (BATCH, t, k, 2)
          and np.isfinite(out["future_points"]).all()
          and np.abs(out["future_points"]).max() <= 1.0, "future_points finite in [-1, 1]")
    check(int(out["pred_im_seq"].max()) > int(out["pred_im_seq"].min()), "the video is not constant")

    act = np.eye(m.n_action, dtype=np.float32)[actions]
    with decode_paths() as paths:
        ops.reset_launch_counts()
        raw = engine.final.generate(images, act, z)
        again = engine.run(images, actions, z)
        twice = ops.launch_counts()
    mask = raw["mask"]
    check(bool(torch.isfinite(raw["pred_im_seq"]).all()) and float(mask.min()) >= 0.0
          and float(mask.max()) <= 1.0, "mask in [0, 1] before quantization, video finite")
    check(all(np.array_equal(out[key], again[key]) for key in engine.OUTPUT_KEYS),
          "the same seeds give the same videos twice")
    check(twice == generate_launches(paths, 2),
          f"every generate call launched 8 / 1 / 2 / 1 / 2 / 28 kernels (decodes: {paths})")
    return counts


def f32_path_phase(cfg, params) -> None:
    """The whole path in float32, once through the kernels and once through
    the plain versions on the card."""
    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.eval import FinalGenerator, request_z

    m = cfg.model
    cfg32 = dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, compute_dtype="float32"))
    gen = FinalGenerator(cfg32, device="cuda")
    gen.load_parameters(params)
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (BATCH, m.image_size, m.image_size, 3)).astype(np.float32)
    act = np.eye(m.n_action, dtype=np.float32)[[1, 2, 6, 7]]
    z = np.stack([request_z(seed, m.vae_dim) for seed in (21, 22, 23, 24)])
    kern = gen.generate(images, act, z)
    ops.reset_launch_counts()
    with plain_path(ops):
        plain = gen.generate(images, act, z)
    check(sum(ops.launch_counts().values()) == 0, "the plain run launched no kernel")
    for key in ("current_points", "future_points", "pred_im_seq", "pred_im_crude", "mask"):
        err = float((kern[key] - plain[key]).abs().max())
        print(f"f32 path {key}: max abs err kernels vs plain {err:.3e}", flush=True)
        check(err <= SLICE_TOL, f"f32 path {key} within {SLICE_TOL}")


def throughput_phase(cfg, params, card: str) -> float:
    import torch

    from kpvid_tpu_torch.eval import FinalGenerator, request_z

    m = cfg.model
    b = 32
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(params)
    rng = np.random.default_rng(2)
    images = torch.as_tensor(
        rng.uniform(-1, 1, (b, m.image_size, m.image_size, 3)).astype(np.float32), device="cuda")
    act = torch.as_tensor(np.eye(m.n_action, dtype=np.float32)[rng.integers(0, m.n_action, b)],
                          device="cuda")
    z = torch.as_tensor(np.stack([request_z(int(sd), m.vae_dim) for sd in range(b)]), device="cuda")
    gen.generate(images, act, z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        out = gen.generate(images, act, z)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(out["pred_im_seq"]).all()), "batch-32 video finite")
    fps = iters * b * m.n_future_frames / dt
    print(f"generate batch {b} bf16: {dt / iters * 1e3:.1f} ms per call, {fps:.1f} frames/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)

    with torch.no_grad():
        # the raw maps reach pose_head in bf16; does .contiguous() copy them?
        raw = gen.stage1.pose_encoder.raw_maps(images)
        line = (f"raw maps at batch {b}: {raw.dtype} {tuple(raw.shape)}, contiguous "
                f"{raw.is_contiguous()}")
        if not raw.is_contiguous():
            line += f", .contiguous() {device_ms(raw.contiguous, 10):.4f} ms"
        print(line, flush=True)

    # the same call through the plain versions, for comparison only
    from kpvid_tpu_torch import ops

    with plain_path(ops):
        t_plain = time_ms(lambda: gen.generate(images, act, z), 1.0)
    print(f"generate batch {b} bf16 through the plain versions: {t_plain:.1f} ms per call, "
          f"{b * m.n_future_frames / t_plain * 1e3:.1f} frames/s", flush=True)
    return fps


def plain_path(ops):
    """Every kernel call site of the path bound to its plain version."""
    import contextlib

    stack = contextlib.ExitStack()
    for target, fn in (
        ("kpvid_tpu_torch.ops.chain.conv3x3_affine", ops.conv3x3_affine_plain),
        ("kpvid_tpu_torch.ops.chain.up2_conv3_affine", ops.up2_conv3_affine_plain),
        ("kpvid_tpu_torch.eval.final.conv3x3_add_affine", ops.conv3x3_add_affine_plain),
        ("kpvid_tpu_torch.models.networks.pose_head", ops.heatmaps_to_keypoints),
        ("kpvid_tpu_torch.eval.final.gaussian_render", ops.render_gaussian_maps),
        ("kpvid_tpu_torch.models.layers.bias_bn_relu", ops.bias_bn_relu_plain),
        ("kpvid_tpu_torch.models.layers.lstm_cell", ops.lstm_cell_plain),
    ):
        stack.enter_context(mock.patch(target, fn))
    return stack


SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_REQUESTS = 96
SERVE_CLIENTS = 16
GIF_EVERY = 24  # every 24th request asks for a GIF: 4 of 96
# bucket 1 against any other bucket, bf16 (PERF.md section 2): images within
# 0.02, i.e. 3 uint8 steps (pred_im_seq's [-1, 1] and the mask's [0, 1] held
# alike); points within two bf16 steps at 1.0
BUCKET_TOL = {"pred_im_seq": 3, "mask": 3, "current_points": 0.016, "future_points": 0.016}
# a bucket's batch through the kernels against the same batch through the
# plain versions, bf16 (PERF.md section 2): images within 0.02, the current
# points within 1e-4 (#3 takes the same maps), future points within two bf16
# steps at 1.0
PATH_TOL = {"pred_im_seq": 0.02, "pred_im_crude": 0.02, "mask": 0.02,
            "current_points": 1e-4, "future_points": 0.016}


def serve_traffic(m) -> list[dict]:
    """The serve phase's requests: PNGs drawn from seed 0, alternating
    landscape and portrait so both crop branches run, cycling actions,
    fixed seeds."""
    from PIL import Image

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(SERVE_REQUESTS):
        w, h = (160, 120) if i % 2 == 0 else (120, 160)
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
        reqs.append({"image": base64.b64encode(buf.getvalue()).decode(),
                     "action": i % m.n_action, "seed": 1000 + i,
                     "format": "gif" if i % GIF_EVERY == GIF_EVERY - 1 else "npz"})
    return reqs


def post(base: str, body: dict) -> tuple[int, str, bytes]:
    req = urllib.request.Request(f"{base}/v1/generate", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def client_process(base: str, reqs: list[dict], out_dir: str) -> None:
    """The load: SERVE_CLIENTS closed-loop threads in a process of their own,
    so that they share no GIL with the daemon. Writes each response body to
    ``<i>.bin`` and the statuses, content types, latencies (s) and the wall
    time to ``meta.json``; stops sending after a failed request."""
    out = Path(out_dir)
    status, ctypes, latency = [None] * len(reqs), [""] * len(reqs), [0.0] * len(reqs)
    lock = threading.Lock()
    todo = iter(range(len(reqs)))
    failed = threading.Event()

    def client():
        while not failed.is_set():
            with lock:
                i = next(todo, None)
            if i is None:
                return
            t0 = time.perf_counter()
            status[i], ctypes[i], body = post(base, reqs[i])
            latency[i] = time.perf_counter() - t0
            (out / f"{i}.bin").write_bytes(body)
            if status[i] != 200:
                failed.set()

    threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (out / "meta.json").write_text(json.dumps({
        "status": status, "ctype": ctypes, "latency": latency,
        "wall": time.perf_counter() - t0}))


def drive(base: str, reqs: list[dict]) -> tuple[list, list, float]:
    """Send every request from ``client_process`` in a spawned process;
    returns the responses (status, content type, body; None if not sent),
    each request's latency in s, and the wall time."""
    import multiprocessing

    with tempfile.TemporaryDirectory(prefix="kpvid_clients_") as tmp:
        proc = multiprocessing.get_context("spawn").Process(
            target=client_process, args=(base, reqs, tmp))
        proc.start()
        proc.join(timeout=600)
        if proc.is_alive():
            proc.kill()
            proc.join()
        check(proc.exitcode == 0, "the client process finished")
        meta = json.loads((Path(tmp) / "meta.json").read_text())
        results = [None if st is None else (st, ct, (Path(tmp) / f"{i}.bin").read_bytes())
                   for i, (st, ct) in enumerate(zip(meta["status"], meta["ctype"]))]
    return results, meta["latency"], meta["wall"]


class HostTimer:
    """Seconds spent in wrapped calls, summed over threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self.lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                    self.calls[name] = self.calls.get(name, 0) + 1
        return timed


def check_bucket_agreement(got: dict, want: dict, what: str) -> dict:
    errs = {}
    for key, tol in BUCKET_TOL.items():
        if got[key].dtype == np.uint8:
            err = int(np.abs(got[key].astype(np.int16) - want[key].astype(np.int16)).max())
        else:
            err = float(np.abs(got[key] - want[key]).max())
        errs[key] = err
        if err > tol:
            raise CheckFailed(f"{what}: {key} differs by {err} (bound {tol})")
    return errs


def serve_phase(cfg, params, card: str) -> dict:
    """The HTTP daemon at Config(), with the pipeline on and off."""
    import torch
    from PIL import Image

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.data.augment import resolve_frame_ops
    from kpvid_tpu_torch.device import start_readback
    from kpvid_tpu_torch.eval import InferenceEngine, device_quantize, make_server, request_z
    from kpvid_tpu_torch.eval import server as server_mod

    m = cfg.model
    t, s, k = m.n_future_frames, m.image_size, m.n_pts
    engine = InferenceEngine(cfg, params, device="cuda")
    reqs = serve_traffic(m)
    report = {}
    first_npz = None
    for pipeline in (True, False):
        timer = HostTimer()
        with mock.patch.object(engine, "dispatch", timer.wrap("dispatch", engine.dispatch)), \
                mock.patch.object(engine, "fetch", timer.wrap("fetch", engine.fetch)), \
                mock.patch.object(server_mod, "preprocess_image",
                                  timer.wrap("preprocess", server_mod.preprocess_image)), \
                mock.patch.object(server_mod, "encode_npz",
                                  timer.wrap("encode_npz", server_mod.encode_npz)), \
                mock.patch.object(server_mod, "encode_gif",
                                  timer.wrap("encode_gif", server_mod.encode_gif)), \
                mock.patch.object(server_mod._Handler, "_send_bytes",
                                  timer.wrap("send", server_mod._Handler._send_bytes)):
            t0 = time.perf_counter()
            server, batcher = make_server(engine, port=0, buckets=SERVE_BUCKETS, warmup=True,
                                          pipeline=pipeline)
            warm_s = time.perf_counter() - t0
            base = f"http://127.0.0.1:{server.server_address[1]}"
            serving = threading.Thread(target=server.serve_forever, daemon=True)
            serving.start()
            try:
                timer.seconds.clear()
                timer.calls.clear()
                with decode_paths() as paths:
                    ops.reset_launch_counts()
                    results, latency, wall = drive(base, reqs)
                    counts = ops.launch_counts()
                with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
                    stats = json.loads(r.read())
                host = dict(timer.seconds)
                calls = dict(timer.calls)
                # one request, twice, alone: the same bucket both times
                again = [post(base, dict(reqs[0], seed=77)) for _ in range(2)]
            finally:
                server.shutdown()
                server.server_close()
                batcher.stop()
                serving.join(timeout=30)
        mode = "pipeline on" if pipeline else "pipeline off"
        check(all(r is not None and r[0] == 200 for r in results),
              f"{mode}: all {len(reqs)} requests answered 200")
        batches = stats["batches_total"]
        check(stats["requests_total"] == len(reqs) and batches > 0,
              f"{mode}: {len(reqs)} requests in {batches} batches")
        check(counts == generate_launches(paths, batches),
              f"{mode}: launches {counts} are 8 / 1 / 2 / 1 / 2 / 28 per dispatched batch "
              f"(decodes: {paths})")
        outs, gifs = {}, []
        for i, (req, (_, ctype, body)) in enumerate(zip(reqs, results)):
            if req["format"] == "gif":
                gifs.append(ctype == "image/gif" and body[:6] in (b"GIF87a", b"GIF89a"))
                continue
            out = dict(np.load(io.BytesIO(body)))
            ok = (out["pred_im_seq"].dtype == np.uint8 and out["pred_im_seq"].shape == (t, s, s, 3)
                  and out["mask"].dtype == np.uint8 and out["mask"].shape == (t, s, s, 1)
                  and out["current_points"].shape == (k, 2)
                  and out["future_points"].shape == (t, k, 2)
                  and np.isfinite(out["current_points"]).all()
                  and np.isfinite(out["future_points"]).all() and int(out["seed"]) == req["seed"])
            if not ok:
                raise CheckFailed(f"{mode}: request {i} has wrong outputs")
            outs[i] = out
        check(len(outs) + len(gifs) == len(reqs) and all(gifs),
              f"{mode}: every npz holds uint8 [32,128,128,3] and [32,128,128,1] and finite "
              f"points, and the {len(gifs)} GIF answers are GIFs")
        a, b = (dict(np.load(io.BytesIO(r[2]))) for r in again)
        check(all(r[0] == 200 for r in again) and all(np.array_equal(a[x], b[x]) for x in a),
              f"{mode}: one request sent twice, alone, comes back with the same bits")
        if first_npz is None:
            first_npz = (outs, a)
        else:
            check(all(np.array_equal(first_npz[1][x], a[x]) for x in a),
                  "the lone request gives the same bits with the pipeline on and off")
        lat = np.sort(np.asarray(latency))
        frames = len(reqs) * t
        rep = {"requests_per_s": len(reqs) / wall, "frames_per_s": frames / wall,
               "wall_s": wall, "warmup_s": warm_s,
               "latency_ms_p50": stats["latency_ms_p50"], "latency_ms_p95": stats["latency_ms_p95"],
               "client_latency_ms_p50": 1e3 * float(lat[len(lat) // 2]),
               "client_latency_ms_p95": 1e3 * float(lat[min(len(lat) - 1, int(len(lat) * 0.95))]),
               "batches": batches, "mean_batch_rows": stats["mean_batch_rows"],
               "pad_fraction": stats["pad_fraction"],
               "host_s": host, "host_calls": calls,
               "launches_per_batch": {n: c / batches for n, c in counts.items()}}
        report["pipeline" if pipeline else "no_pipeline"] = rep
        print(f"serve ({mode}) on {card}: {rep['requests_per_s']:.2f} requests/s, "
              f"{rep['frames_per_s']:.1f} frames/s, {len(reqs)} requests in {wall:.3f} s from "
              f"{SERVE_CLIENTS} clients; batcher latency p50 {rep['latency_ms_p50']:.1f} ms, p95 "
              f"{rep['latency_ms_p95']:.1f} ms; client latency p50 "
              f"{rep['client_latency_ms_p50']:.1f} ms, p95 {rep['client_latency_ms_p95']:.1f} ms; "
              f"{batches} batches, mean batch rows {rep['mean_batch_rows']:.2f}, pad fraction "
              f"{rep['pad_fraction']:.3f}; warm-up {warm_s:.2f} s", flush=True)
        print(f"serve ({mode}) host seconds, summed over threads: " + ", ".join(
            f"{n} {v:.3f} s in {calls[n]} calls" for n, v in sorted(host.items())) +
            f" (wall {wall:.3f} s)", flush=True)

    # the same requests alone at bucket 1, and 32 of them at once, not counted
    outs, _ = first_npz
    ops_ = resolve_frame_ops("auto")
    prep = {i: server_mod.preprocess_image(Image.open(io.BytesIO(base64.b64decode(r["image"]))),
                                           s, ops_)
            for i, r in enumerate(reqs)}

    def alone(i):
        return {x: v[0] for x, v in engine.run(prep[i][None], np.asarray([reqs[i]["action"]]),
                                                request_z(reqs[i]["seed"], m.vae_dim)[None]).items()}

    npz_ids = sorted(outs)
    worst = {}
    for i in npz_ids[:4]:
        errs = check_bucket_agreement(outs[i], alone(i), f"response {i} vs bucket 1")
        worst = {x: max(worst.get(x, 0), e) for x, e in errs.items()}
    check(True, f"4 daemon responses agree with bucket 1: {worst}")
    ids32 = npz_ids[:32]
    batch = engine.run(np.stack([prep[i] for i in ids32]),
                       np.asarray([reqs[i]["action"] for i in ids32]),
                       np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids32]))
    worst = {}
    for j in range(0, 32, 8):
        errs = check_bucket_agreement({x: v[j] for x, v in batch.items()}, alone(ids32[j]),
                                      f"row {j} of bucket 32 vs bucket 1")
        worst = {x: max(worst.get(x, 0), e) for x, e in errs.items()}
    check(True, f"bucket 32 agrees with bucket 1 on rows 0, 8, 16, 24: {worst}")
    report["bucket32_vs_bucket1"] = worst

    # every bucket's batch through the kernels and through the plain versions
    report["kernels_vs_plain_per_bucket"] = {}
    for b in SERVE_BUCKETS:
        ids = npz_ids[:b]
        args = (np.stack([prep[i] for i in ids]),
                np.eye(m.n_action, dtype=np.float32)[[reqs[i]["action"] for i in ids]],
                np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids]))
        with torch.no_grad():
            kern = engine.final.generate(*args)
            with plain_path(ops):
                plain = engine.final.generate(*args)
        errs = {x: float((kern[x].float() - plain[x].float()).abs().max()) for x in PATH_TOL}
        bad = {x: e for x, e in errs.items() if not e <= PATH_TOL[x]}
        if bad:
            raise CheckFailed(f"bucket {b}: kernels vs plain {bad} (bounds {PATH_TOL})")
        report["kernels_vs_plain_per_bucket"][b] = errs
        check(True, f"bucket {b}: the path through the kernels agrees with the plain versions, "
                    "bf16: " + ", ".join(f"{x} {e:.3e}" for x, e in errs.items()))
        del kern, plain

    # the engine alone, no HTTP traffic: host clock of one run per bucket
    report["engine_run_ms"] = {}
    for b in SERVE_BUCKETS:
        ids = npz_ids[:b]
        args = (np.stack([prep[i] for i in ids]), np.asarray([reqs[i]["action"] for i in ids]),
                np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids]))
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.run(*args)
            runs.append(1e3 * (time.perf_counter() - t0))
        report["engine_run_ms"][b] = float(np.median(runs))
    print("engine.run alone (dispatch + readback, host clock, median of 5): " + ", ".join(
        f"bucket {b} {ms:.2f} ms" for b, ms in report["engine_run_ms"].items()), flush=True)

    # the batch-32 readback alone: copy-stream time of the uint8 outputs
    z = np.stack([request_z(reqs[i]["seed"], m.vae_dim) for i in ids32])
    act = np.eye(m.n_action, dtype=np.float32)[[reqs[i]["action"] for i in ids32]]
    with torch.no_grad():
        out = engine.final.generate(np.stack([prep[i] for i in ids32]), act, z)
        quant = {"pred_im_seq": device_quantize(out["pred_im_seq"]),
                 "mask": device_quantize(out["mask"], rescale=False),
                 "current_points": out["current_points"].float(),
                 "future_points": out["future_points"].float()}
    torch.cuda.synchronize()
    n_bytes = sum(v.numel() * v.element_size() for v in quant.values())
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        copy_stream = engine.mesh.replicas[0].copy_stream
        start.record(copy_stream)
        rb = start_readback(quant, copy_stream)
        end.record(copy_stream)
        rb.wait()
        end.synchronize()
        times.append(start.elapsed_time(end))
    report["readback_b32_ms"] = times

    # one response's encoding alone: one thread, no load
    one = outs[npz_ids[0]]
    n_raw = sum(v.nbytes for v in one.values())
    enc = {}
    for name, fn in (("npz", lambda: server_mod.encode_npz(one, int(one["seed"]))),
                     ("gif", lambda: server_mod.encode_gif(one["pred_im_seq"]))):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            body = fn()
            runs.append(1e3 * (time.perf_counter() - t0))
        enc[name] = {"ms": float(np.median(runs)), "bytes": len(body)}
    report["encode_alone"] = enc
    print(f"one response encoded alone (one thread, no load, median of 5): npz "
          f"{enc['npz']['ms']:.2f} ms ({n_raw / 1e6:.2f} MB -> {enc['npz']['bytes'] / 1e6:.2f} MB), "
          f"GIF {enc['gif']['ms']:.2f} ms ({enc['gif']['bytes'] / 1e6:.2f} MB); the outputs "
          "come from random weights", flush=True)
    print(f"batch-32 readback of {n_bytes / 1e6:.1f} MB (uint8 video and mask, f32 points) on "
          f"the copy stream: {', '.join(f'{x:.3f}' for x in times)} ms "
          f"({n_bytes / min(times) / 1e6:.1f} GB/s)", flush=True)
    return report


# the CPU-traced file's bucket (the daemon's and the batch-32 timing's); the
# card traces the single request's
ARTIFACT_BUCKETS = (32,)
CARD_TRACE_BUCKETS = (1,)
ARTIFACT_REQUESTS = 16
# modules a process that only loads and serves an artifact must not import
NOT_FOR_ARTIFACTS = ("kpvid_tpu_torch.models", "kpvid_tpu_torch.configs",
                     "kpvid_tpu_torch.checkpoint", "jax", "kpvid_tpu.")


def artifact_child(path: str, inputs_path: str, out_dir: str) -> None:
    """A fresh process that imports the loader and the engine and nothing of
    the model: loads the artifact onto the card, runs each bucket's batch
    (once to warm up, once counted) and writes the outputs, the launch
    counts per batch, the load time and the forbidden modules it imported."""
    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.eval.export import load_serving
    from kpvid_tpu_torch.eval.server import ArtifactEngine

    t0 = time.perf_counter()
    engine = ArtifactEngine(load_serving(path, device="cuda"))
    load_s = time.perf_counter() - t0
    report = {"load_s": load_s, "buckets": list(engine.buckets), "launches": {}}
    with np.load(inputs_path) as data:
        for b in engine.buckets:
            args = tuple(data[f"{name}_{b}"] for name in ("images", "actions", "z"))
            engine.run(*args)
            ops.reset_launch_counts()
            out = engine.run(*args)
            report["launches"][b] = ops.launch_counts()
            np.savez(Path(out_dir) / f"out_{b}.npz", **out)
    report["modules"] = sorted(m for m in sys.modules if m.startswith(NOT_FOR_ARTIFACTS))
    (Path(out_dir) / "report.json").write_text(json.dumps(report))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_process(proc, timeout: float = 600) -> int:
    """Wait for a multiprocessing child, killed past ``timeout``; its exit
    code."""
    proc.join(timeout=timeout)
    if proc.is_alive():
        proc.kill()
        proc.join()
    return proc.exitcode


def artifact_phase(cfg, params, card: str, root: Path) -> dict:
    """The serving artifact at Config() in bf16: traced on the card and on
    the CPU, each loaded by a fresh process onto the card (started once its
    file is written) and held against InferenceEngine, the batch-32 generate
    timed against the live one, and the daemon served from the CPU-traced
    file."""
    import multiprocessing

    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.eval import InferenceEngine, request_z
    from kpvid_tpu_torch.eval.export import export_serving, load_serving

    spawn = multiprocessing.get_context("spawn")
    m = cfg.model
    t, s, k = m.n_future_frames, m.image_size, m.n_pts
    engine = InferenceEngine(cfg, params, device="cuda")
    report = {"files": {}, "children": {}}
    buckets = {"cuda": CARD_TRACE_BUCKETS, "cpu": ARTIFACT_BUCKETS}
    paths = {dev: root / f"serving_{dev}.npz" for dev in buckets}

    rng = np.random.default_rng(5)
    batches = {}
    for b in sorted(CARD_TRACE_BUCKETS + ARTIFACT_BUCKETS):
        batches[b] = (rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
                      rng.integers(0, m.n_action, b),
                      np.stack([request_z(500 + i, m.vae_dim) for i in range(b)]))
    np.savez(root / "artifact_inputs.npz", **{
        f"{name}_{b}": arr for b, args in batches.items()
        for name, arr in zip(("images", "actions", "z"), args)})
    live = {b: engine.run(*args) for b, args in batches.items()}

    # each file traced here in turn and loaded by a fresh process of its own
    # once written (the first while the second is traced); the daemon from
    # the CPU-traced file starts with the second's loader and warms up while
    # this process loads that file too
    procs, t_load = {}, {}
    for traced_on in ("cuda", "cpu"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        meta = export_serving(engine.final, paths[traced_on], batch_sizes=buckets[traced_on],
                              device=traced_on)
        export_s = time.perf_counter() - t0
        n_bytes = paths[traced_on].stat().st_size
        check(meta["device"] == traced_on and meta["batch_sizes"] == list(buckets[traced_on])
              and sum(ops.launch_counts().values()) == 0,
              f"artifact traced on {traced_on}: buckets {meta['batch_sizes']}, {n_bytes} bytes "
              f"in {export_s:.1f} s, no kernel launched while tracing")
        report["files"][traced_on] = {"bytes": n_bytes, "export_s": export_s,
                                      "outputs": meta["outputs"],
                                      "torch_version": meta["torch_version"]}
        out_dir = root / f"artifact_child_{traced_on}"
        out_dir.mkdir()
        t_load[traced_on] = time.perf_counter()
        procs[traced_on] = spawn.Process(target=artifact_child, args=(
            str(paths[traced_on]), str(root / "artifact_inputs.npz"), str(out_dir)))
        procs[traced_on].start()
    with np.load(paths["cpu"]) as data:
        report["bytes_per_program"] = {b: int(data[f"graph_b{b}"].size) for b in ARTIFACT_BUCKETS}
    print(f"artifact bytes per bucket program: {report['bytes_per_program']}", flush=True)
    daemon = start_daemon(["--artifact", str(paths["cpu"])], "serve --artifact", root)
    try:
        art = load_serving(paths["cpu"], device="cuda")
        for traced_on, proc in procs.items():
            out_dir = root / f"artifact_child_{traced_on}"
            code = join_process(proc)
            check(code == 0, f"a fresh process loaded the {traced_on}-traced artifact and ran "
                             f"every bucket ({time.perf_counter() - t_load[traced_on]:.1f} s from "
                             "its start)")
            child = json.loads((out_dir / "report.json").read_text())
            check(child["modules"] == [], f"loading and serving the {traced_on}-traced artifact "
                                          "imported no models, configs, checkpoint or JAX")
            worst, identical = {}, True
            for b in buckets[traced_on]:
                counts = child["launches"][str(b)]
                check(counts == EXPECTED_LAUNCHES,
                      f"{traced_on}-traced artifact, bucket {b}: launches {counts} are "
                      "8 / 1 / 2 / 1 / 2 / 28 / 64")
                with np.load(out_dir / f"out_{b}.npz") as got:
                    for key in engine.OUTPUT_KEYS:
                        a, w = got[key], live[b][key]
                        identical &= bool(np.array_equal(a, w))
                        if a.dtype == np.uint8:
                            err = int(np.abs(a.astype(np.int16) - w.astype(np.int16)).max())
                            bound = 1
                        else:
                            err = float(np.abs(a - w).max())
                            bound = 1e-5
                        worst[key] = max(worst.get(key, 0), err)
                        if err > bound:
                            raise CheckFailed(f"{traced_on}-traced artifact, bucket {b}: {key} "
                                              f"differs from InferenceEngine by {err} (bound "
                                              f"{bound})")
            check(True, f"{traced_on}-traced artifact on the card agrees with InferenceEngine at "
                        f"buckets {buckets[traced_on]}: {worst}; the same bits: {identical}")
            report["children"][traced_on] = {"load_s": child["load_s"], "worst": worst,
                                             "identical": identical,
                                             "launches_per_batch":
                                                 child["launches"][str(max(buckets[traced_on]))]}

        # batch 32: the artifact's generate against the live one, on cuda inputs
        im, actions, z = batches[32]
        args = (torch.as_tensor(im, device="cuda"),
                torch.as_tensor(np.eye(m.n_action, dtype=np.float32)[actions], device="cuda"),
                torch.as_tensor(z, device="cuda"))
        timing = {}
        with torch.no_grad():
            for name, fn in (("live", lambda: engine.final.generate(*args)),
                             ("artifact", lambda: art.generate(*args)),
                             ("artifact again", lambda: art.generate(*args)),
                             ("live again", lambda: engine.final.generate(*args))):
                timing[name] = {"host_loop_ms": time_ms(fn, 1.0),
                                "device_ms": device_ms(fn, 1, 1.0)}
        frames = 32 * t
        for name, r in timing.items():
            r["frames_per_s"] = frames / r["host_loop_ms"] * 1e3
            print(f"generate batch 32 bf16, {name}: host loop {r['host_loop_ms']:.2f} ms "
                  f"({r['frames_per_s']:.1f} frames/s), device {r['device_ms']:.2f} ms on {card}",
                  flush=True)
        report["b32"] = timing
        del art
        report["serve"] = finish_daemon(daemon, m, ARTIFACT_BUCKETS, engine)
    finally:
        stop_daemon(daemon)
    for path in paths.values():
        path.unlink()
    return report


def start_daemon(argv: list, what: str, root: Path) -> dict:
    """``python -m kpvid_tpu_torch.serve`` with ``argv`` on a free port in a
    process of its own, its output in a log under ``root``; returns the
    handle :func:`finish_daemon` and :func:`stop_daemon` take."""
    port = free_port()
    log_path = root / f"{what.replace(' ', '_').replace('-', '')}.log"
    log = log_path.open("w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kpvid_tpu_torch.serve", *argv, "--port", str(port)],
        cwd=Path(__file__).resolve().parent, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "log_path": log_path, "what": what,
            "base": f"http://127.0.0.1:{port}", "t0": time.perf_counter()}


def stop_daemon(daemon: dict) -> None:
    proc = daemon["proc"]
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    daemon["log"].close()


def finish_daemon(daemon: dict, m, buckets, engine) -> dict:
    """/healthz once the daemon of :func:`start_daemon` is up (``up_s``: the
    seconds from its start, load and warm-up), ARTIFACT_REQUESTS requests
    from a spawned client, every npz checked, response 0 against ``engine``
    at bucket 1; the daemon stopped before it returns."""
    from PIL import Image

    from kpvid_tpu_torch.data.augment import resolve_frame_ops
    from kpvid_tpu_torch.eval import server as server_mod
    from kpvid_tpu_torch.eval import request_z

    s, t, k = m.image_size, m.n_future_frames, m.n_pts
    what, base, proc = daemon["what"], daemon["base"], daemon["proc"]
    try:
        health = None
        while health is None and proc.poll() is None and time.perf_counter() - daemon["t0"] < 600:
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - daemon["t0"]
        if health is None:
            daemon["log"].flush()
            print(daemon["log_path"].read_text()[-4000:], flush=True)
        check(health == {"status": "ok", "image_size": s, "n_action": m.n_action,
                         "n_future_frames": t, "buckets": list(buckets)},
              f"{what} is up {up_s:.1f} s after its start (load and warm-up; polled from "
              f"then on): /healthz {health}")
        reqs = serve_traffic(m)[:ARTIFACT_REQUESTS]
        results, latency, wall = drive(base, reqs)
    finally:
        stop_daemon(daemon)
    check(all(r is not None and r[0] == 200 for r in results),
          f"{what} answered all {len(reqs)} requests 200 in {wall:.2f} s")
    first = None
    for i, (req, (_, ctype, body)) in enumerate(zip(reqs, results)):
        out = dict(np.load(io.BytesIO(body)))
        if not (ctype == "application/x-npz" and out["pred_im_seq"].dtype == np.uint8
                and out["pred_im_seq"].shape == (t, s, s, 3) and out["mask"].dtype == np.uint8
                and out["mask"].shape == (t, s, s, 1) and out["current_points"].shape == (k, 2)
                and out["future_points"].shape == (t, k, 2)
                and np.isfinite(out["future_points"]).all() and int(out["seed"]) == req["seed"]):
            raise CheckFailed(f"{what}: request {i} has wrong outputs")
        if first is None:
            first = out
    image = server_mod.preprocess_image(Image.open(io.BytesIO(base64.b64decode(reqs[0]["image"]))),
                                        s, resolve_frame_ops("auto"))
    want = engine.run(image[None], np.asarray([reqs[0]["action"]]),
                      request_z(reqs[0]["seed"], m.vae_dim)[None])
    errs = check_bucket_agreement(first, {x: v[0] for x, v in want.items()},
                                  f"{what} response 0 vs InferenceEngine at bucket 1")
    check(True, f"{what}: every npz holds the contract; response 0 agrees with "
                f"InferenceEngine: {errs}")
    return {"up_s": up_s, "wall_s": wall, "requests": len(reqs),
            "requests_per_s": len(reqs) / wall, "response0_vs_engine": errs}


def label_phase(cfg, params, card: str, root: Path) -> dict:
    """The labeler on a synthetic tree at 128-frame chunks, bf16. Leaves the
    tree (``root/penn``, its labels) and the stage-1 parameter file
    (``root/stage1.npz``) for the later phases."""
    import torch

    from kpvid_tpu_torch import make_pseudo_labels, ops
    from kpvid_tpu_torch.checkpoint import save_parameters
    from kpvid_tpu_torch.data import (
        VideoFramesDataset,
        make_synthetic_penn_tree,
        pack_chunks,
    )
    from kpvid_tpu_torch.data.image_pair import read_split
    from kpvid_tpu_torch.device import to_device

    m = cfg.model
    chunk = 128
    t0 = time.perf_counter()
    make_synthetic_penn_tree(root / "penn", n_train=24, n_test=8)
    tree_s = time.perf_counter() - t0
    ckpt = save_parameters(root / "stage1.npz",
                           {k: v for k, v in params.items() if k.startswith("stage1.")})
    (root / "cfg.yaml").write_text(json.dumps({  # JSON is YAML
        "paths": {"data_dir": str(root / "penn")},
        "training": {"compute_dtype": cfg.training.compute_dtype},
        "model": dataclasses.asdict(m),
        "data": {"labeler_chunk": chunk},
    }))
    ops.reset_launch_counts()
    stats = make_pseudo_labels.main(["--config", str(root / "cfg.yaml"),
                                     "--checkpoint", str(ckpt), "--device", "cuda"])
    counts = ops.launch_counts()
    n_frames = stats["frames"]
    check(stats["videos"] == 32 and stats["chunks"] == -(-n_frames // chunk),
          f"labeled 32 videos, {n_frames} frames, in {stats['chunks']} chunks of {chunk}")
    check(counts == per_chunk(DETECT_LAUNCHES, stats["chunks"]),
          f"launches {counts}: one pose_head and 22 bias_bn_relu per chunk, nothing else")
    labels = {}
    for subset in ("train", "test"):
        for rel, _ in read_split(str(root / "penn"), subset):
            vid = int(rel.split("/")[-1])
            n = len(list((root / "penn" / rel).iterdir()))
            arr = np.load(root / "penn" / "pseudo_labels" / f"{vid:04d}.npy")
            if not (arr.shape == (n, m.n_pts, 2) and arr.dtype == np.float32
                    and np.isfinite(arr).all() and np.abs(arr).max() <= 1.0):
                raise CheckFailed(f"labels of video {vid}: {arr.shape} {arr.dtype}")
            labels[vid] = arr
    check(len(labels) == 32, "one finite [n, 40, 2] label file in [-1, 1] per video")

    # the first chunk again: raw maps, the kernel and the plain soft-argmax
    enc, _ = make_pseudo_labels.load_pose_encoder(cfg, str(ckpt), torch.device("cuda"))
    ds = VideoFramesDataset(str(root / "penn"), "train", m.image_size, as_uint8=True)
    slab, segs = next(pack_chunks(ds.iter_videos(), chunk))
    with torch.no_grad():
        x = to_device(slab, torch.device("cuda")).float() / 255.0 * 2.0 - 1.0
        raw = enc.raw_maps(x).contiguous()
        got = ops.pose_head(raw)
        want = ops.heatmaps_to_keypoints(raw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"pose_head on a {tuple(raw.shape)} {raw.dtype} chunk within 1e-5 "
                       f"of the plain soft-argmax: max abs err {err:.3e}")
    pts = got.cpu().numpy()
    label_err = max(float(np.abs(labels[vid][v_off:v_off + c] - pts[s_off:s_off + c]).max())
                    for vid, _, v_off, s_off, c in segs)
    check(label_err <= 1e-5, f"the labels of the first chunk are the kernel's points: max "
                             f"abs diff {label_err:.3e}")
    n_bytes = raw.numel() * raw.element_size() + 4.0 * chunk * m.n_pts * 2
    n_ops = 2.0 * raw.numel() + 6.0 * chunk * m.n_pts * 2 * m.image_size
    kern = dict(ms=device_ms(lambda: ops.pose_head(raw), reps=20),
                host_loop_ms=time_ms(lambda: ops.pose_head(raw)),
                plain_ms=time_ms(lambda: ops.heatmaps_to_keypoints(raw)), max_abs_err=err)
    kern["bound_ms"], kern["bound_by"] = bound_ms(n_bytes, n_ops, "float32")
    fps = n_frames / stats["seconds"]
    print(f"label on {card}: {n_frames} frames of 32 videos in {stats['seconds']:.3f} s, "
          f"{fps:.1f} frames/s; decode thread busy {stats['decode_seconds']:.3f} s "
          f"({100 * stats['decode_seconds'] / stats['seconds']:.1f}% of the wall time), labeling "
          f"loop waiting for slabs {stats['wait_seconds']:.3f} s "
          f"({100 * stats['wait_seconds'] / stats['seconds']:.1f}%); tree written in "
          f"{tree_s:.2f} s", flush=True)
    print(f"pose_head on a labeling chunk {tuple(raw.shape)} {raw.dtype} ({n_bytes / 1e6:.1f} MB): "
          f"device {kern['ms']:.4f} ms ({100 * kern['bound_ms'] / kern['ms']:.1f}% of the bound "
          f"{kern['bound_ms']:.4f} ms), host loop {kern['host_loop_ms']:.4f} ms, plain "
          f"{kern['plain_ms']:.4f} ms", flush=True)
    return dict(frames=n_frames, videos=stats["videos"], chunks=stats["chunks"],
                seconds=stats["seconds"], frames_per_s=fps,
                decode_seconds=stats["decode_seconds"], wait_seconds=stats["wait_seconds"],
                launches=counts, pose_head_chunk=kern)


TRAIN_BATCH = 16
TRAIN_STEPS = 40
TRAIN_CKPT = 20
# the card's f32 step against the CPU's (TF32 off on both): losses within
# rtol 1e-4; each gradient tensor within 1e-3 of its own max |CPU| (sums in
# another order on each side; the encoder's gradients are ill-conditioned
# where the KL term's 1/sigma is large, see tests/test_torch_gpu.py)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-3
EVAL_LAUNCHES = {"conv3x3_affine": 8, "conv3x3_add_affine": 1, "up2_conv3_affine": 2,
                 "pose_head": 1, "gaussian_render": 4, "pose_head_backward": 0,
                 "gaussian_render_backward": 0, "bias_bn_relu": 28, "lstm_cell": 64}


def train_config(cfg, root: Path, name: str, log: str, data: dict | None = None,
                 **training) -> Path:
    """A YAML (JSON is YAML) of ``cfg``'s model for the trainers on phase 6's
    tree, batch 16, a checkpoint every 20 steps, one summary and one test
    sweep (at step 0), and no vgg19.npy (stage 1 synthesizes its weights);
    ``data`` sets keys of the data section."""
    path = root / f"{name}.yaml"
    path.write_text(json.dumps({
        "paths": {"data_dir": str(root / "penn"), "log_dir": str(root / log),
                  "vggnet": str(root / "no_vgg19.npy")},
        "training": {"compute_dtype": cfg.training.compute_dtype, "batch_size": TRAIN_BATCH,
                     "checkpoint_interval": TRAIN_CKPT, "summary_interval": 1000,
                     "test_interval": 1000, "log_interval": 10, **training},
        "model": dataclasses.asdict(cfg.model),
        "data": data or {},
    }))
    return path


def moved_and_finite(run: dict, what: str) -> None:
    """Every loss of a trainer run's last step is finite and every parameter
    tensor differs from its initial value."""
    import torch

    from kpvid_tpu_torch.train.cli import init_key

    trainer = run["trainer"]
    init = trainer.init_parameters(init_key(trainer.config.training.seed))  # the CLI's
    still = [k for k, v in trainer.model.state_dict().items()
             if torch.equal(v.detach().cpu(), init[k])]
    check(all(np.isfinite(v) for v in run["metrics"].values()) and not still,
          f"{what}: every loss finite ("
          + ", ".join(f"{k} {v:.4g}" for k, v in run["metrics"].items())
          + f"), all {len(init)} parameter tensors moved")


S1_STEPS = 40
S1_CKPT = 20
S1_BATCH = TRAIN_BATCH
BWD_F32_REL = 1e-5  # f32 gradients: within 1e-5 of the tensor's max |plain|
# the f32 stage-1 step, card against CPU: each gradient tensor within 5% in
# relative L2. Element by element the two differ by a few % of a tensor's
# max: the step's gradient is not continuous in its inputs (ReLU and leaky
# ReLU kinks, the max-pools, the perceptual loss's L1 signs), so a forward
# that moves by an ulp turns some of those terms over; the phase measures
# the card against itself with the source frame one ulp off to show it
S1_GRAD_L2 = 5e-2
BWD_POINTS_BF16_REL = 1e-4  # the points' f32 gradient from bf16 cotangents
# biases whose gradient is zero in exact arithmetic (a conv's before a
# train-mode BN, which takes the batch mean off; the heat map's, which the
# soft-argmax does not see): each side's value is its own rounding
ZERO_GRAD = (".conv.bias", ".heat.bias")
# the image encoder's last octave feeds nothing of stage 1 (the translator
# takes the 1/4-resolution features): its parameters get zero gradients
S1_UNUSED = ("stage1.image_encoder.trunk.down2.", "stage1.image_encoder.trunk.keep2.")
S1_PER_STEP = dict(NO_LAUNCHES, pose_head=1, gaussian_render=2, pose_head_backward=1,
                   gaussian_render_backward=2)


def rel_gap(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


# the backwards' edge shapes besides the path's: one image or frame and 33
# at 30^2 (rows that split unevenly over an image's blocks, a cluster's last
# band short), with K = 40 and with K = 6, which takes the element-wise path
BWD_EDGE = [(n, 30, k) for n in (1, 33) for k in (40, 6)]


def check_pose_backward(gen, shape, dtype) -> tuple[float, tuple]:
    """#3's backward on random [B, H, W, K] maps against the plain soft-argmax's
    torch autograd: f32 within BWD_F32_REL of the max; bf16 within one bf16
    step of each element or that bound, where the two marginals' terms
    cancel. The same bits twice, and the training form's points are the
    inference form's. Returns the max abs error and the inputs."""
    import torch

    from kpvid_tpu_torch import ops

    b, _, _, k = shape
    raw = (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    ct = torch.randn((b, k, 2), generator=gen, device="cuda")
    pts, p, q = torch.ops.kpvid.pose_head_train(raw)
    got = ops.pose_head_backward(ct, pts, p, q, dtype)
    again = ops.pose_head_backward(ct, pts, p, q, dtype)
    torch.cuda.synchronize()
    raw_req = raw.clone().requires_grad_()
    (want,) = torch.autograd.grad(ops.heatmaps_to_keypoints(raw_req), raw_req, ct)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if dtype == torch.float32:
        ok = err <= BWD_F32_REL * scale
    else:
        g32, w32 = got.float(), want.float()
        step = 2.0**-7 * torch.maximum(g32.abs(), w32.abs())
        ok = bool(((g32 - w32).abs() <= torch.clamp(step, min=BWD_F32_REL * scale)).all())
    check(ok and torch.equal(got, again) and torch.equal(pts, ops.pose_head(raw)),
          f"pose_head_backward {tuple(shape)} {dtype}: max abs err {err:.3e} of max "
          f"{scale:.3e} against plain autograd; the same bits twice; the training form's "
          "points are the inference form's")
    return err, (raw, ct, pts, p, q)


def check_render_backward(gen, n, hs, k, inv_std, od) -> tuple[float, tuple]:
    """#4's backward from a random [N, hs, hs, K] cotangent in ``od`` against the
    plain render's torch autograd (f32 within BWD_F32_REL, bf16 within
    BWD_POINTS_BF16_REL of the max), the same bits twice. Returns the max abs
    error and the inputs."""
    import torch

    from kpvid_tpu_torch import ops

    mu = torch.rand((n, k, 2), generator=gen, device="cuda") * 2 - 1
    ct = torch.randn((n, hs, hs, k), generator=gen, device="cuda").to(od)
    got = ops.gaussian_render_backward(ct, mu, inv_std)
    again = ops.gaussian_render_backward(ct, mu, inv_std)
    torch.cuda.synchronize()
    mu_req = mu.clone().requires_grad_()
    maps = ops.render_gaussian_maps(mu_req, hs, hs, inv_std, out_dtype=od)
    (want,) = torch.autograd.grad(maps, mu_req, ct, retain_graph=True)
    gap = rel_gap(got, want)
    err = float((got - want).abs().max())
    bound = BWD_F32_REL if od == torch.float32 else BWD_POINTS_BF16_REL
    check(gap <= bound and torch.equal(got, again),
          f"gaussian_render_backward {tuple(ct.shape)} {od} -> {tuple(mu.shape)}: max abs err "
          f"{err:.3e}, {gap:.2e} of the max (bound {bound}); the same bits twice")
    return err, (ct, mu, mu_req, maps)


def backward_kernel_phase(m, card: str) -> dict:
    """#3's and #4's backwards against the plain versions' torch autograd at
    stage 1's training shapes and at BWD_EDGE, f32 and bf16, and their times
    at the training shapes beside the bound and the launch floor (an empty
    kernel's device time in the same graph measurement)."""
    import torch

    from kpvid_tpu_torch import ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, k = 2 * S1_BATCH, m.image_size, m.n_pts
    hs, n = m.heatmap_size, S1_BATCH
    for en, ehw, ek in BWD_EDGE:
        for dtype in (torch.float32, torch.bfloat16):
            check_pose_backward(gen, (en, ehw, ehw, ek), dtype)
            check_render_backward(gen, en, ehw, ek, m.heatmap_inv_std, dtype)
    print(f"pose_head_backward and gaussian_render_backward at {BWD_EDGE} (N, H = W, K), f32 "
          "and bf16: within their bounds of plain autograd, the same bits twice", flush=True)
    floor = device_ms(lambda: torch.cuda._sleep(0), reps=50)

    rec = dict(library_ms=None, launch_floor_ms=floor)
    for dtype in (torch.float32, torch.bfloat16):
        err, (raw, ct, pts, p, q) = check_pose_backward(gen, (b, s, s, k), dtype)
        rec["max_abs_err_f32" if dtype == torch.float32 else "max_abs_err"] = err
    # the path's dtype: bf16
    bwd = lambda: ops.pose_head_backward(ct, pts, p, q, torch.bfloat16)  # noqa: E731
    rec["ms"] = device_ms(bwd, reps=20)
    rec["host_loop_ms"] = time_ms(bwd)
    # the 41.9 MB output fits the 50 MB L2: the same launches with a 64 MB
    # write between them, less that write alone, say what a cold L2 costs
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rec["ms_after_64mb_write"] = (device_ms(lambda: (scratch.fill_(1), bwd()), reps=20)
                                  - device_ms(lambda: scratch.fill_(1), reps=20))
    del scratch
    # the card's practical write rate: the same bytes written by zero_()
    grad = torch.empty((b, s, s, k), dtype=torch.bfloat16, device="cuda")
    rec["zero_fill_ms"] = device_ms(lambda: grad.zero_(), reps=20)
    del grad
    raw_req = raw.clone().requires_grad_()
    plain_pts = ops.heatmaps_to_keypoints(raw_req)
    rec["plain_ms"] = time_ms(
        lambda: torch.autograd.grad(plain_pts, raw_req, ct, retain_graph=True))
    n_bytes = b * s * s * k * 2 + 4.0 * b * k * (2 * s) + 4.0 * 2 * b * k * 2
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, 3.0 * b * s * s * k, "float32")
    fwd_train = device_ms(lambda: torch.ops.kpvid.pose_head_train(raw), reps=20)
    fwd_inf = device_ms(lambda: ops.pose_head(raw), reps=20)
    print(f"pose_head_backward bf16 [{b}, {s}, {s}, {k}] per stage-1 step on {card}: device "
          f"{rec['ms']:.4f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound "
          f"{rec['bound_ms']:.4f} ms, {rec['bound_by']}; launch floor {floor:.4f} ms; the same "
          f"bytes by zero_() {rec['zero_fill_ms']:.4f} ms), after a 64 MB write "
          f"{rec['ms_after_64mb_write']:.4f} ms, host loop "
          f"{rec['host_loop_ms']:.4f} ms, plain autograd {rec['plain_ms']:.4f} ms; the "
          f"forward's training form {fwd_train:.4f} ms against its inference form "
          f"{fwd_inf:.4f} ms", flush=True)
    records = {"pose_head_backward": dict(rec, forward_train_ms=fwd_train,
                                          forward_inference_ms=fwd_inf)}

    rec = dict(library_ms=None, launch_floor_ms=2 * floor)
    for od in (torch.float32, torch.bfloat16):
        err, (ct, mu, mu_req, maps) = check_render_backward(gen, n, hs, k, m.heatmap_inv_std, od)
        rec["max_abs_err_f32" if od == torch.float32 else "max_abs_err"] = err
    # two launches a step, each at this shape, in bf16
    args = (ct, mu, m.heatmap_inv_std)
    rec["ms"] = 2 * device_ms(lambda: ops.gaussian_render_backward(*args), reps=50)
    rec["host_loop_ms"] = 2 * time_ms(lambda: ops.gaussian_render_backward(*args))
    rec["plain_ms"] = 2 * time_ms(
        lambda: torch.autograd.grad(maps, mu_req, ct, retain_graph=True))
    n_bytes = 2 * (ct.numel() * 2 + 4.0 * n * k * 2 * 2)
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, 2 * 8.0 * ct.numel(), "float32")
    print(f"gaussian_render_backward bf16 2 x [{n}, {hs}, {hs}, {k}] per stage-1 step on {card}: "
          f"device {rec['ms']:.4f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound "
          f"{rec['bound_ms']:.4f} ms, {rec['bound_by']}; launch floor {2 * floor:.4f} ms), host "
          f"loop {rec['host_loop_ms']:.4f} ms, plain autograd {rec['plain_ms']:.4f} ms",
          flush=True)
    records["gaussian_render_backward"] = rec
    return records


def stage1_moved_and_finite(run: dict, what: str) -> None:
    """Every loss of the run's last step finite; every parameter and BN
    statistic moved from its init, the pose encoder's included, except the
    image encoder's last octave, which the stage-1 graph does not read (and a
    bias whose gradient is zero in exact arithmetic may stay, if its rounding
    gave exact zeros every step)."""
    import torch

    from kpvid_tpu_torch.train.cli import init_key

    trainer = run["trainer"]
    init = trainer.init_parameters(init_key(trainer.config.training.seed))  # the CLI's
    still = {k for k, v in trainer.model.state_dict().items()
             if torch.equal(v.detach().cpu(), init[k])}
    unused = {k for k in init if k.startswith(S1_UNUSED) and "running_" not in k}
    zero = {k for k in still if k.endswith(ZERO_GRAD)} - unused
    pose = [k for k in init if k.startswith("stage1.pose_encoder.")]
    check(all(np.isfinite(v) for v in run["metrics"].values()) and still == unused | zero
          and unused <= still and not set(pose) & (still - zero),
          f"{what}: every loss finite ("
          + ", ".join(f"{k} {v:.4g}" for k, v in run["metrics"].items())
          + f"); {len(init) - len(still)} of {len(init)} tensors moved, the {len(pose)} of the "
          f"pose encoder among them; unmoved: the image encoder's {len(unused)} unread tensors "
          f"and {len(zero)} zero-gradient biases {sorted(zero)}")


def stage1_phase(cfg, card: str, root: Path) -> dict:
    """Stage 1 at Config() in bf16 on phase 6's tree, with synthesized VGG19
    weights."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.checkpoint import list_checkpoint_steps, load_checkpoint
    from kpvid_tpu_torch.data import HostDataPipeline, ImagePairDataset
    from kpvid_tpu_torch.device import to_device
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import Stage1Trainer
    from kpvid_tpu_torch.train import main as train_main

    m = cfg.model
    kernels = backward_kernel_phase(m, card)
    args = ["--mode", "detector_translator", "--max-steps", str(S1_STEPS)]
    ops.reset_launch_counts()
    run = train_main(args + ["--config", str(train_config(cfg, root, "s1_a", "log_s1"))])
    counts = ops.launch_counts()
    ck = root / "log_s1" / "detector_translator"
    # the 40 steps, plus one forward each for the test sweep (8 videos: one
    # batch) and for the summary images at step 0
    want = {name: c * S1_STEPS for name, c in S1_PER_STEP.items()}
    for name in ("pose_head", "gaussian_render"):
        want[name] += 2 * S1_PER_STEP[name]
    want["bias_bn_relu"] += 2 * S1_INFERENCE_BN
    check(counts == want, f"the stage-1 run launched {counts}: 1 / 2 forward and 1 / 2 backward "
                          "#3 / #4 a step (+ the test sweep's and the summary's forwards, with "
                          "their inference BN), no #1 / #2")
    check(list_checkpoint_steps(ck) == [S1_CKPT, S1_STEPS],
          f"checkpoints at steps {S1_CKPT} and {S1_STEPS}")
    stage1_moved_and_finite(run, f"{S1_STEPS} fused stage-1 steps at Config(), bf16, batch "
                                 f"{S1_BATCH}")
    tests = [json.loads(ln) for ln in (ck / "test_metrics.jsonl").read_text().splitlines()]
    images = sorted(p.name for p in (ck / "train_images").iterdir())
    check(len(tests) == 1 and all(np.isfinite(v) for v in tests[0].values()) and len(images) == 14,
          f"one test sweep (finite: loss_G {tests[0]['loss_G']:.4g}, psnr {tests[0]['psnr']:.3f}) "
          f"and one summary write ({len(images)} PNGs)")

    # one step of each mode, counted alone
    trainer = run["trainer"]
    ds = ImagePairDataset(str(root / "penn"), "train", image_size=m.image_size)
    pipe = HostDataPipeline(ds, S1_BATCH, shuffle=True, repeat=True, seed=5)
    batches = pipe.batches()
    host = [next(batches), next(batches)]
    batches.close()
    dev = [{k: to_device(v, trainer.device) for k, v in b.items()} for b in host]
    per_mode = {}
    for mode, step in (("fused", lambda: trainer.train_step(dev[0])),
                       ("fused_dg", lambda: trainer.train_step_dg(dev[0])),
                       ("two_batch", lambda: trainer.train_step_two_batch(dev[0], dev[1]))):
        ops.reset_launch_counts()
        step()
        per_mode[mode] = ops.launch_counts()
    extra = dict(S1_PER_STEP, pose_head=2, gaussian_render=4)
    check(per_mode["fused"] == S1_PER_STEP and per_mode["fused_dg"] == extra
          and per_mode["two_batch"] == extra,
          f"launches per step: fused {per_mode['fused']}; fused_dg and two_batch add one #3 and "
          "two #4 forwards (the discriminator's no-grad generator forward)")

    # cuDNN's determinism: the CLI asks for deterministic algorithms; two
    # gradient passes from one state, with and without
    def grads_twice():
        outs = []
        for _ in range(2):
            saved = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
            g, _, _ = trainer.g_grads(*trainer._pair_of(dev[0]))
            trainer.generator.load_state_dict(saved)
            outs.append([x.clone() for x in g])
        return sum(not torch.equal(a, b) for a, b in zip(*outs))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    differ_free = grads_twice()
    torch.backends.cudnn.deterministic = True
    differ_det = grads_twice()
    torch.backends.cudnn.deterministic = deterministic
    print(f"two gradient passes from one state: {differ_free} of {len(trainer._g_params)} "
          f"gradient tensors differ with cuDNN free to choose, {differ_det} with "
          f"cudnn.deterministic (the CLI sets it: {deterministic})", flush=True)

    # resume from the step-20 checkpoint in a log dir of its own, to step 40
    shutil.copytree(ck / f"ckpt-{S1_CKPT}", root / "log_s1b" / "detector_translator"
                    / f"ckpt-{S1_CKPT}")
    resumed = train_main(args + ["--config", str(train_config(cfg, root, "s1_b", "log_s1b"))])
    want_a = load_checkpoint(ck / f"ckpt-{S1_STEPS}")
    got_a = load_checkpoint(root / "log_s1b" / "detector_translator" / f"ckpt-{S1_STEPS}")
    differ = [k for k in want_a if not np.array_equal(want_a[k], got_a.get(k))]
    check(resumed["start_step"] == S1_CKPT + 1 and sorted(got_a) == sorted(want_a) and not differ,
          f"resumed at step {resumed['start_step']}, the stage-1 run ends with the uninterrupted "
          f"run's bits in all {len(want_a)} arrays (both networks, BN statistics, both Adam "
          f"states); differing: {len(differ)} {differ[:5]}")

    for mode in ("fused_dg", "two_batch"):
        other = train_main(["--mode", "detector_translator", "--max-steps", "3", "--no-images",
                            "--config", str(train_config(cfg, root, f"s1_{mode}",
                                                         f"log_s1_{mode}", gan_step_mode=mode))])
        check(all(np.isfinite(v) for v in other["metrics"].values()),
              f"3 {mode} stage-1 steps: every loss finite ("
              + ", ".join(f"{k} {v:.4g}" for k, v in other["metrics"].items()) + ")")

    # one f32 step at Config() widths, batch 2, on the card and on the CPU,
    # and on the card again with the source frame moved by one f32 ulp: the
    # step's own sensitivity to its inputs' last bit
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=2))
    vgg = synthesize_vgg19_params()
    small = {k: v[:2] for k, v in host[0].items()}
    nudged = dict(small, image=np.nextafter(small["image"], np.float32(2)))
    steps = {}
    for key, dev_name, batch in (("cuda", "cuda", small), ("cpu", "cpu", small),
                                 ("cuda_ulp", "cuda", nudged)):
        t = Stage1Trainer(cfg32, vgg, device=dev_name)
        t.load_parameters(t.init_parameters(1))
        im, fim = t._pair_of(batch)
        g_grads, fake, g_m = t.g_grads(im, fim)
        d_grads, d_m = t.d_grads(fim, fake)
        names = ["stage1." + n for n in t._g_names] + ["image_discriminator." + n
                                                       for n in t._d_names]
        steps[key] = ({k: float(v) for k, v in {**g_m, **d_m}.items()},
                      {n: g.detach().cpu() for n, g in zip(names, list(g_grads) + list(d_grads))})
    (lc, gc), (lp, gp), (_, gu) = steps["cuda"], steps["cpu"], steps["cuda_ulp"]
    loss_gap = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    kept = [n for n in gp if not n.endswith(ZERO_GRAD) and not n.startswith(S1_UNUSED)]
    max_gap = {n: rel_gap(gc[n], gp[n]) for n in kept}
    l2_gap = {n: float((gc[n] - gp[n]).norm()) / max(float(gp[n].norm()), 1e-30) for n in kept}
    ulp_gap = {n: rel_gap(gc[n], gu[n]) for n in kept}
    ulp_l2 = {n: float((gc[n] - gu[n]).norm()) / max(float(gu[n].norm()), 1e-30) for n in kept}
    worst = max(max_gap, key=max_gap.get)
    worst_l2 = max(l2_gap, key=l2_gap.get)
    worst_ulp = max(ulp_gap, key=ulp_gap.get)
    within = sum(v <= STEP_GRAD_REL for v in max_gap.values())
    print(f"f32 stage-1 step at Config(), batch 2, card vs CPU: losses "
          + ", ".join(f"{k} {lc[k]:.6g} / {lp[k]:.6g}" for k in lp)
          + f"; worst loss gap {loss_gap:.3e}; gradients: {within} of {len(kept)} tensors within "
          f"{STEP_GRAD_REL} of their max, worst {max_gap[worst]:.3e} ({worst}), worst relative "
          f"L2 gap {l2_gap[worst_l2]:.3e} ({worst_l2}); the card against itself with the source "
          f"frame one ulp off: worst {ulp_gap[worst_ulp]:.3e} ({worst_ulp}), worst relative L2 "
          f"{max(ulp_l2.values()):.3e}", flush=True)
    check(loss_gap <= STEP_LOSS_RTOL and l2_gap[worst_l2] <= S1_GRAD_L2,
          f"the card's f32 stage-1 step agrees with the CPU's: losses within {STEP_LOSS_RTOL}, "
          f"every gradient tensor within {S1_GRAD_L2} in relative L2 ({len(kept)} tensors; not "
          "the biases whose gradient is zero in exact arithmetic, nor the unread octave)")

    # the bf16 step's time: host clock, synchronised, median of 10 after warm-up
    for _ in range(3):
        trainer.train_step(dev[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(dev[0])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = float(np.median(times))
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(dev[0])
        torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kerns = device_records(prof)
    device_step_ms = sum(us for _, _, us in kerns) / 1e3
    n_kernels = sum(n for _, n, _ in kerns)
    top = sorted(kerns, key=lambda r: -r[2])[:6]
    ours = {key: us / 1e3 for key, _, us in kerns if "keypoint" in key
            or "render" in key or "pose_head" in key}
    # the raw records against key_averages() on this one step (every other
    # profile of the smoke reads the records alone)
    averaged = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    avg_ms = sum(e.self_device_time_total for e in averaged) / 1e3
    check(sum(e.count for e in averaged) == n_kernels
          and abs(avg_ms - device_step_ms) <= 1e-6 * avg_ms + 1e-6,
          f"the profile's raw records give key_averages()'s device operations and time: "
          f"{n_kernels} operations, {device_step_ms:.6f} ms (key_averages() {avg_ms:.6f} ms)")
    rep = {"step_ms": step_ms, "step_ms_all": times, "examples_per_s": S1_BATCH / step_ms * 1e3,
           "device_step_ms": device_step_ms if n_kernels else None, "kernels_per_step": n_kernels,
           "peak_gib": peak_gib, "seconds_40_steps": run["seconds"], "f32_loss_gap": loss_gap,
           "f32_grad_max_gap": max_gap[worst], "f32_grad_max_gap_tensor": worst,
           "f32_grad_l2_gap": l2_gap[worst_l2], "f32_grad_l2_gap_tensor": worst_l2,
           "f32_grad_tensors_within_1e-3": within, "f32_grad_tensors": len(kept),
           "f32_one_ulp_max_gap": ulp_gap[worst_ulp], "f32_one_ulp_l2_gap": max(ulp_l2.values()),
           "grads_differ_cudnn_free": differ_free, "grads_differ_cudnn_deterministic": differ_det,
           "launches_per_step": S1_PER_STEP, "launches_per_step_modes": per_mode,
           "keypoint_kernels_in_profile_ms": ours, "kernels": kernels}
    print(f"stage 1 on {card}: bf16 step at batch {S1_BATCH}: {step_ms:.2f} ms (median of 10, "
          f"host clock, synchronised; all {', '.join(f'{x:.1f}' for x in times)}), "
          f"{rep['examples_per_s']:.1f} examples/s, peak memory {peak_gib:.2f} GiB; the 40-step "
          f"run took {run['seconds']:.2f} s", flush=True)
    if n_kernels:
        print(f"stage-1 step device time (torch.profiler, sum of its {n_kernels} kernels): "
              f"{device_step_ms:.3f} ms, {100 * device_step_ms / step_ms:.1f}% of the step; "
              f"keypoint kernels {ours}; top: "
              + "; ".join(f"{key[:50]} x{n} {us / 1e3:.3f} ms" for key, n, us in top),
              flush=True)
    else:
        print("stage-1 step device time: not measured, torch.profiler (CUPTI) recorded no "
              "kernel on the card", flush=True)
    return rep


def relabel_phase(cfg, root: Path) -> dict:
    """The labeler again, now with the stage-1 trainer's newest checkpoint:
    the labels stage 2 trains on come from the port's own detector."""
    from kpvid_tpu_torch import make_pseudo_labels, ops

    before = {p.name: np.load(p) for p in (root / "penn" / "pseudo_labels").glob("*.npy")}
    ops.reset_launch_counts()
    stats = make_pseudo_labels.main(["--config", str(root / "cfg.yaml"), "--checkpoint",
                                     str(root / "log_s1" / "detector_translator"),
                                     "--device", "cuda"])
    counts = ops.launch_counts()
    after = {p.name: np.load(p) for p in (root / "penn" / "pseudo_labels").glob("*.npy")}
    moved = sum(not np.array_equal(before[k], after[k]) for k in before)
    check(stats["videos"] == 32 and counts == per_chunk(DETECT_LAUNCHES, stats["chunks"])
          and sorted(after) == sorted(before) and moved == len(before)
          and all(np.isfinite(a).all() and np.abs(a).max() <= 1.0 for a in after.values()),
          f"relabeled 32 videos from the stage-1 ckpt-{S1_STEPS} ({stats['frames']} frames, "
          f"{stats['chunks']} chunks, one pose_head each), every label file rewritten, finite, "
          "in [-1, 1]")
    return {"frames_per_s": stats["frames"] / stats["seconds"], "chunks": stats["chunks"]}


def s2_launches(cfg, root: Path, sweeps: int = 0, forwards: int = 0) -> dict:
    """The launches of a bf16 stage-2 run on the card: lstm_cell alone, one a
    step and layer of each LSTM forward that autograd does not record. A
    test sweep's batch (phase 6's test split at TRAIN_BATCH) runs the
    encoder over the real sequence, the decoder over n_future_frames and the
    discriminator over the (real, fake) pair in one batch; a summary runs
    the generator alone, encoder and decoder. The training steps record
    every forward and launch nothing."""
    from kpvid_tpu_torch.data import SequenceDataset

    m = cfg.model
    n_test = len(SequenceDataset(str(root / "penn"), "test", m.n_pts, m.n_action,
                                 image_size=m.image_size))
    real = cfg.data.sequence_len - 1  # the first frame is the keypoints' start
    generator = real + m.n_future_frames
    batch = generator + m.n_future_frames
    per_layer = sweeps * -(-n_test // TRAIN_BATCH) * batch + forwards * generator
    return dict(NO_LAUNCHES, lstm_cell=len(m.cell_info) * per_layer)


def train_phase(cfg, card: str, root: Path) -> dict:
    """Stage 2 at Config() in bf16 on phase 6's tree and the labels of the
    stage-1 checkpoint."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.checkpoint import list_checkpoint_steps, load_checkpoint
    from kpvid_tpu_torch.data import HostDataPipeline, SequenceDataset
    from kpvid_tpu_torch.device import to_device
    from kpvid_tpu_torch.train import Stage2Trainer
    from kpvid_tpu_torch.train import main as train_main
    from kpvid_tpu_torch.train.cli import step_noise
    from kpvid_tpu_torch.utils import jax_random

    m = cfg.model
    args = ["--mode", "motion_generator", "--max-steps", str(TRAIN_STEPS)]
    ops.reset_launch_counts()
    run = train_main(args + ["--config", str(train_config(cfg, root, "train_a", "log_a"))])
    counts = ops.launch_counts()
    ck = root / "log_a" / "motion_generator"
    want = s2_launches(cfg, root, sweeps=1, forwards=1)
    check(counts == want, f"the trainer launched {counts}: lstm_cell {want['lstm_cell']} for the "
                          "test sweep's and the summary's forwards, nothing for the steps")
    check(list_checkpoint_steps(ck) == [TRAIN_CKPT, TRAIN_STEPS],
          f"checkpoints at steps {TRAIN_CKPT} and {TRAIN_STEPS}")
    moved_and_finite(run, f"{TRAIN_STEPS} fused steps at Config(), bf16, batch {TRAIN_BATCH}")
    tests = [json.loads(ln) for ln in (ck / "test_metrics.jsonl").read_text().splitlines()]
    images = sorted(p.name for p in (ck / "train_images").iterdir())
    check(len(tests) == 1 and all(np.isfinite(v) for v in tests[0].values()) and len(images) == 8,
          f"one test sweep (finite: loss_G {tests[0]['loss_G']:.4g}) and one summary write "
          f"({len(images)} PNGs)")

    # resume from the step-20 checkpoint in a log dir of its own, to step 40
    shutil.copytree(ck / f"ckpt-{TRAIN_CKPT}", root / "log_b" / "motion_generator"
                    / f"ckpt-{TRAIN_CKPT}")
    resumed = train_main(args + ["--config", str(train_config(cfg, root, "train_b", "log_b"))])
    want = load_checkpoint(ck / f"ckpt-{TRAIN_STEPS}")
    got = load_checkpoint(root / "log_b" / "motion_generator" / f"ckpt-{TRAIN_STEPS}")
    differ = [k for k in want if not np.array_equal(want[k], got.get(k))]
    check(resumed["start_step"] == TRAIN_CKPT + 1 and sorted(got) == sorted(want) and not differ,
          f"resumed at step {resumed['start_step']}, the run ends with the uninterrupted run's "
          f"bits in all {len(want)} arrays (parameters and Adam state); differing: {differ[:5]}")

    for mode in ("fused_dg", "two_batch"):
        other = train_main(["--mode", "motion_generator", "--max-steps", "3", "--no-images",
                            "--config", str(train_config(cfg, root, f"train_{mode}",
                                                         f"log_{mode}", gan_step_mode=mode))])
        moved_and_finite(other, f"3 {mode} steps")

    # one fused step in f32 on the card and on the CPU
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=TRAIN_BATCH))
    ds = SequenceDataset(str(root / "penn"), "train", m.n_pts, m.n_action, image_size=m.image_size)
    batch = next(HostDataPipeline(ds, TRAIN_BATCH, shuffle=True, repeat=True, seed=0).batches())
    noise = step_noise(jax_random.PRNGKey(0), 1, TRAIN_BATCH, m.vae_dim)[0]
    steps = {}
    for dev in ("cuda", "cpu"):
        t = Stage2Trainer(cfg32, device=dev)
        t.load_parameters(t.init_parameters(1))
        first_pt, real_seq, act = t._flatten_batch(batch)
        g_grads, pred, g_m = t.g_grads(first_pt, real_seq, act, noise)
        d_grads, d_m = t.d_grads(real_seq, pred)
        names = t._g_names + t._d_names
        steps[dev] = ({k: float(v) for k, v in {**g_m, **d_m}.items()},
                      {n: g.detach().cpu() for n, g in zip(names, list(g_grads) + list(d_grads))})
    (lc, gc), (lp, gp) = steps["cuda"], steps["cpu"]
    loss_gap = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    grad_gap = {n: float((gc[n] - gp[n]).abs().max()) / max(float(gp[n].abs().max()), 1e-30)
                for n in gp}
    worst = max(grad_gap, key=grad_gap.get)
    print(f"f32 fused step at Config(), batch {TRAIN_BATCH}, card vs CPU: losses "
          + ", ".join(f"{k} {lc[k]:.6g} / {lp[k]:.6g}" for k in lp)
          + f"; worst relative gap: losses {loss_gap:.3e}, gradients {grad_gap[worst]:.3e} "
          f"({worst})", flush=True)
    check(loss_gap <= STEP_LOSS_RTOL and grad_gap[worst] <= STEP_GRAD_REL,
          f"the card's f32 step agrees with the CPU's: losses within {STEP_LOSS_RTOL}, every "
          f"gradient within {STEP_GRAD_REL} of its max")

    # the bf16 step's time: host clock, synchronised, median of 10 after warm-up
    trainer = run["trainer"]
    dev_batch = {k: to_device(v, trainer.device) for k, v in batch.items()}
    dev_noise = to_device(noise, trainer.device)
    for _ in range(3):
        trainer.train_step(dev_batch, dev_noise)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(dev_batch, dev_noise)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = float(np.median(times))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(dev_batch, dev_noise)
        torch.cuda.synchronize()
    kernels = device_records(prof)
    device_step_ms = sum(us for _, _, us in kernels) / 1e3
    n_kernels = sum(n for _, n, _ in kernels)
    top = sorted(kernels, key=lambda r: -r[2])[:5]
    rep = {"step_ms": step_ms, "step_ms_all": times, "examples_per_s": TRAIN_BATCH / step_ms * 1e3,
           "device_step_ms": device_step_ms if n_kernels else None, "kernels_per_step": n_kernels,
           "seconds_40_steps": run["seconds"], "f32_loss_gap": loss_gap,
           "f32_grad_gap": grad_gap[worst], "f32_grad_gap_tensor": worst,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items()}}
    print(f"train on {card}: bf16 step at batch {TRAIN_BATCH}: {step_ms:.2f} ms (median of 10, "
          f"host clock, synchronised; all {', '.join(f'{x:.1f}' for x in times)}), "
          f"{rep['examples_per_s']:.1f} examples/s; the 40-step run took {run['seconds']:.2f} s",
          flush=True)
    if n_kernels:
        print(f"train step device time (torch.profiler, sum of its {n_kernels} kernels): "
              f"{device_step_ms:.3f} ms, {100 * device_step_ms / step_ms:.1f}% of the step; top: "
              + "; ".join(f"{key[:50]} x{n} {us / 1e3:.3f} ms" for key, n, us in top),
              flush=True)
    else:
        print("train step device time: not measured, torch.profiler (CUPTI) recorded no "
              "kernel on the card", flush=True)
    return rep


def evaluate_phase(cfg, card: str, root: Path) -> dict:
    """evaluate on phase 6's 8 test videos with the stage-1 trainer's newest
    checkpoint and the stage-2 trainer's ckpt-40."""
    import torch

    from kpvid_tpu_torch import evaluate, ops

    m = cfg.model
    conf = train_config(cfg, root, "eval", "log_eval")
    ckpt = root / "log_a" / "motion_generator" / f"ckpt-{TRAIN_STEPS}"
    runs, trees, per_batch = [], [], {}
    for name in ("eval_a", "eval_b"):
        with decode_paths() as paths:
            ops.reset_launch_counts()
            stats = evaluate.main(["--config", str(conf), "--checkpoint_stage1",
                                   str(root / "log_s1" / "detector_translator"),
                                   "--checkpoint_stage2", str(ckpt),
                                   "--save_dir", str(root / name)])
            counts = ops.launch_counts()
        check(stats["samples"] == 8 and stats["batches"] == 1
              and counts == generate_launches(paths, stats["batches"], EVAL_LAUNCHES),
              f"evaluate wrote 8 samples in {stats['batches']} batch; launches {counts} are "
              f"8 / 1 / 2 / 1 / 4 / 28 per batch (decodes: {paths})")
        per_batch = {k: v / stats["batches"] for k, v in counts.items()}
        files = {p.relative_to(root / name).as_posix(): p.read_bytes()
                 for p in sorted((root / name).rglob("*.png"))}
        for i in range(8):
            if not png_tree_complete(root / name / f"{i:04d}", m.n_future_frames):
                raise CheckFailed(f"sample {i}: incomplete PNG tree")
        check(len(files) == 8 * (2 + 5 * m.n_future_frames),
              f"{name}: each sample has 2 PNGs and 5 directories of {m.n_future_frames} PNGs")
        runs.append(stats)
        trees.append(files)
        print(f"evaluate ({name}) on {card}: 8 samples in {stats['seconds']:.3f} s "
              f"({8 / stats['seconds']:.2f} samples/s); waiting for the batch (JPEG decode) "
              f"{stats['data_seconds']:.3f} s, generate and point images "
              f"{stats['generate_seconds']:.3f} s, PNG writers {stats['write_seconds']:.3f} s "
              f"summed over {stats['png_workers']} threads", flush=True)
    check(trees[0] == trees[1], "a second run with the same seed writes the same bytes")

    # #4 at the point images' shapes: current [8, K, 2] on the f32 grid, future
    # [8 * 32, K, 2] on the bf16 grid; JAX writes each map in its points' dtype
    gen = torch.Generator(device="cuda").manual_seed(2)
    s, k = m.image_size, m.n_pts
    rec = {"ms": 0.0, "host_loop_ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
           "max_abs_err_f32": 0.0}
    tot_bytes = tot_ops = 0.0
    for rows, gd in ((8, torch.float32), (8 * m.n_future_frames, torch.bfloat16)):
        errs, mu = check_render(gen, m, rows, gd, s)
        rec["max_abs_err_f32"] = max(rec["max_abs_err_f32"], errs[torch.float32])
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[torch.bfloat16])
        args = (mu, s, s, m.heatmap_inv_std, gd, gd)
        t_dev = device_ms(lambda: ops.gaussian_render(*args), reps=10)
        t_host = time_ms(lambda: ops.gaussian_render(*args))
        t_plain = time_ms(lambda: ops.render_gaussian_maps(*args))
        n_bytes = 4.0 * rows * k * 2 + (4.0 if gd == torch.float32 else 2.0) * rows * s * s * k
        n_ops = rows * (s * s * k + 8.0 * k * 2 * s)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        print(f"gaussian_render {tuple(mu.shape)} -> [{rows}, {s}, {s}, {k}] {gd}: device "
              f"{t_dev:.4f} ms ({100 * b_ms / t_dev:.1f}% of the bound {b_ms:.4f} ms, {b_by}), "
              f"host loop {t_host:.4f} ms, plain {t_plain:.4f} ms", flush=True)
        rec["ms"] += t_dev
        rec["host_loop_ms"] += t_host
        rec["plain_ms"] += t_plain
        tot_bytes += n_bytes
        tot_ops += n_ops
    rec["bound_ms"], rec["bound_by"] = bound_ms(tot_bytes, tot_ops, "float32")
    print(f"gaussian_render per evaluate batch (point images, 128^2): device {rec['ms']:.4f} ms "
          f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound {rec['bound_ms']:.4f} ms), "
          f"host loop {rec['host_loop_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms", flush=True)
    return {"runs": runs, "launches_per_batch": per_batch, "render_128": rec,
            "samples_per_s": [8 / r["seconds"] for r in runs]}


DP_STEPS = 3
DP_BATCH = TRAIN_BATCH  # global; 2 ranks on the card take 8 rows each
DP_ENV = ("KPVID_COORDINATOR", "KPVID_NUM_PROCESSES", "KPVID_PROCESS_ID", "KPVID_DIST_BACKEND")
# one step with the bf16 all-reduce against the f32 one: Adam's first update
# is lr * g / (|g| + eps), so where bf16 rounding flips the sign of a
# near-zero gradient the two differ by 2 lr (tests/test_dp_step.py:167-181)
BF16_ENVELOPE_LR = 2.05
# stage 2, 2 ranks against one process, and grad_accum 2 against 1 (f32):
# parameters within 1e-5 (tests/test_dp_step.py:159-165), but where Adam's
# first update is a sign step (a first-step gradient below 1e-6, whose sign
# each side's rounding decides): 2 lr there (tests/test_torch_train.py)
DP_S2_PARAM_ATOL = 1e-5
SIGN_STEP_GRAD = 1e-6
DP_WORKER_TIMEOUT_S = 420


def keep_reduced_grads(trainer) -> list:
    """Wrap the trainer's gradient reduction so that the reduced gradients of
    each update are kept on the host, keyed by state-dict name ('fused': the
    generator's update first)."""
    reduce, kept = trainer._reduce_grads, []
    names = [[f"{trainer.G_PREFIX}.{n}" for n in trainer._g_names],
             [f"{trainer.D_PREFIX}.{n}" for n in trainer._d_names]]

    def recording(grads):
        out = reduce(grads)
        group = names[0] if len(out) == len(names[0]) else names[1]
        kept.append({n: g.detach().float().cpu().clone() for n, g in zip(group, out)})
        return out

    trainer._reduce_grads = recording
    return kept


def params_of(trainer) -> dict:
    """A host copy of the trainer's arrays (a copy on the CPU as well)."""
    return {k: v.detach().float().cpu().clone() for k, v in trainer.model.state_dict().items()}


def s2_params_agree(got: dict, want: dict, grads: dict, lr: float, what: str) -> dict:
    """Stage 2's bound: every parameter within DP_S2_PARAM_ATOL, or within
    2 lr where its first-step gradient is below SIGN_STEP_GRAD."""
    worst, beyond, sign_steps = 0.0, 0, 0
    for k, g in grads.items():
        diff = (got[k] - want[k]).abs()
        worst = max(worst, float(diff.max()))
        out = diff > DP_S2_PARAM_ATOL
        beyond += int(out.sum())
        sign = g.abs() < SIGN_STEP_GRAD
        sign_steps += int((out & sign).sum())
        if bool((out & ~sign).any()) or bool((diff[out] > 2.05 * lr).any()):
            raise CheckFailed(f"{what}: {k} differs by {float(diff.max()):.3e}, beyond "
                              f"{DP_S2_PARAM_ATOL} where the gradient is not a sign step")
    check(True, f"{what}: every parameter within {DP_S2_PARAM_ATOL} (worst {worst:.3e}; "
                f"{beyond} elements beyond it, all sign steps within 2 lr)")
    return {"worst": worst, "beyond": beyond, "sign_steps": sign_steps}


def s1_grads_agree(got: dict, want: dict, what: str) -> float:
    """Stage 1's bound (phase 7): each gradient tensor within S1_GRAD_L2 in
    relative L2, but the biases whose gradient is zero in exact arithmetic
    and the unread octave."""
    kept = [n for n in want if not n.endswith(ZERO_GRAD) and not n.startswith(S1_UNUSED)]
    l2 = {n: float((got[n] - want[n]).norm()) / max(float(want[n].norm()), 1e-30) for n in kept}
    worst = max(l2, key=l2.get)
    check(l2[worst] <= S1_GRAD_L2, f"{what}: every gradient tensor within {S1_GRAD_L2} in "
                                   f"relative L2 ({len(kept)} tensors, worst {l2[worst]:.3e} "
                                   f"{worst})")
    return l2[worst]


def tree_bytes(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.png"))}


def dp_inputs(cfg, root: Path) -> dict:
    """A global batch of each stage from phase 6's tree (and step 0's noise)."""
    from kpvid_tpu_torch.data import HostDataPipeline, ImagePairDataset, SequenceDataset
    from kpvid_tpu_torch.train.cli import step_noise
    from kpvid_tpu_torch.utils import jax_random

    m = cfg.model
    out = {}
    for stage, ds in ((1, ImagePairDataset(str(root / "penn"), "train", image_size=m.image_size)),
                      (2, SequenceDataset(str(root / "penn"), "train", m.n_pts, m.n_action,
                                          image_size=m.image_size))):
        batches = HostDataPipeline(ds, DP_BATCH, shuffle=True, repeat=True, seed=9).batches()
        out[stage] = next(batches)
        batches.close()
    out["noise"] = step_noise(jax_random.PRNGKey(0), 1, DP_BATCH, m.vae_dim)[0]
    return out


def step_args(stage: int, inputs: dict, rows: slice, device):
    from kpvid_tpu_torch.device import to_device

    batch = {k: to_device(v[rows], device) for k, v in inputs[stage].items()}
    return (batch,) if stage == 1 else (batch, inputs["noise"])


def dp_rank_worker(job_path: str) -> int:
    """One rank of phase 10's two processes on the card (gloo): a f32 step
    of each stage on its 8 rows, the bf16 probe, the labeler and evaluate.
    Writes rank{r}.npz / rank{r}.json into the job's directory."""
    import hashlib

    import torch
    import torch.distributed as dist

    from kpvid_tpu_torch import evaluate, make_pseudo_labels, ops, parallel
    from kpvid_tpu_torch.configs import Config
    from kpvid_tpu_torch.losses import synthesize_vgg19_params

    job = json.loads(Path(job_path).read_text())
    out = Path(job["out"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    multiproc = parallel.maybe_initialize("cuda")
    rank, world = parallel.world()
    cfg = Config().validate()
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=DP_BATCH))
    inputs = {1: dict(np.load(job["s1_batch"])), 2: dict(np.load(job["s2_batch"]))}
    inputs["noise"] = inputs[2].pop("noise")
    b = DP_BATCH // world
    arrays, info = {}, {"rank": rank, "world": world, "multiproc": multiproc,
                        "backend": dist.get_backend(), "device": str(torch.cuda.current_device())}
    for stage in (2, 1):
        vgg = synthesize_vgg19_params() if stage == 1 else None
        trainer, step = parallel.make_dp_reduce_step(cfg32, stage, vgg_params=vgg)
        trainer.load_parameters(trainer.init_parameters(1))
        kept = keep_reduced_grads(trainer)
        ops.reset_launch_counts()
        metrics = step(*step_args(stage, inputs, slice(rank * b, (rank + 1) * b), trainer.device))
        info[f"s{stage}_launches"] = ops.launch_counts()
        info[f"s{stage}_metrics"] = {k: float(v) for k, v in metrics.items()}
        params = params_of(trainer)
        info[f"s{stage}_digest"] = hashlib.sha256(b"".join(
            params[k].numpy().tobytes() for k in sorted(params))).hexdigest()
        if rank == 0:
            arrays.update({f"s{stage}_after/{k}": v.numpy() for k, v in params.items()})
            for group in kept:
                arrays.update({f"s{stage}_grad/{k}": v.numpy() for k, v in group.items()})
        del trainer, step, kept
        torch.cuda.empty_cache()

    # does gloo sum bf16, on the card and on the host? (no up-cast in silence)
    for where in ("cuda", "cpu"):
        x = torch.full((1000,), 1.5 + rank, dtype=torch.bfloat16, device=where)
        try:
            dist.all_reduce(x)
            info[f"gloo_bf16_{where}"] = f"ok, sum {float(x[0])}"
        except RuntimeError as e:
            info[f"gloo_bf16_{where}"] = f"refused: {str(e).splitlines()[0]}"

    ops.reset_launch_counts()
    stats = make_pseudo_labels.main(job["label_args"])
    info["label"] = {"launches": ops.launch_counts(), "videos": stats["videos"],
                     "frames": stats["frames"], "chunks": stats["chunks"],
                     "seconds": stats["seconds"]}
    with decode_paths() as paths:
        ops.reset_launch_counts()
        stats = evaluate.main(job["evaluate_args"])
        counts = ops.launch_counts()
    info["evaluate"] = {"launches": counts, "decodes": paths, "samples": stats["samples"],
                        "batches": stats["batches"], "seconds": stats["seconds"]}
    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(info))
    return 0


def spawn_ranks(job: dict, out: Path, flag: str, n: int = 2) -> list[dict]:
    """``chip_smoke.py {flag} job.json`` ``n`` times through the KPVID_*
    contract, sharing the card over gloo; all must exit 0 within the time
    limit."""
    import os

    out.mkdir(parents=True, exist_ok=True)
    (out / "job.json").write_text(json.dumps(dict(job, out=str(out))))
    port = free_port()
    procs, logs = [], []
    for pid in range(n):
        env = dict(os.environ, KPVID_COORDINATOR=f"127.0.0.1:{port}", KPVID_NUM_PROCESSES=str(n),
                   KPVID_PROCESS_ID=str(pid), KPVID_DIST_BACKEND="gloo",
                   KPVID_COLLECTIVE_TIMEOUT="300")
        logs.append(out / f"rank{pid}.log")
        with logs[-1].open("w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), flag,
                 str(out / "job.json")], env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DP_WORKER_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise CheckFailed(f"a rank exited {p.returncode}:\n{log.read_text()[-3000:]}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


def dp_phase(cfg, card: str, root: Path, base_step_ms: dict) -> dict:
    """Phase 10 (a), (e), (c): data parallelism through the KPVID_* contract
    at world size 1 on NCCL in this process; the collectives of a step;
    grad_accum (:func:`dp_ranks_phase` runs the two ranks). ``base_step_ms``:
    the single-process step ms of
    phases 7 and 8 (keyed by stage), printed beside the data-parallel step's."""
    import os

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from kpvid_tpu_torch import ops, parallel
    from kpvid_tpu_torch.bench_train import profile_totals
    from kpvid_tpu_torch.checkpoint import load_checkpoint
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer
    from kpvid_tpu_torch.train import main as train_main

    m = cfg.model
    lr = cfg.training.lr.start_val * cfg.training.lr.scale
    dev = torch.device("cuda")
    inputs = dp_inputs(cfg, root)
    rep = {}
    modes = {1: "detector_translator", 2: "motion_generator"}
    sweep = {1: dict(NO_LAUNCHES, pose_head=1, gaussian_render=2, bias_bn_relu=S1_INFERENCE_BN),
             2: s2_launches(cfg, root, sweeps=1)}
    per_step = {1: S1_PER_STEP, 2: NO_LAUNCHES}

    def cli(stage: int, name: str, **training):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        run = train_main(["--mode", modes[stage], "--max-steps", str(DP_STEPS), "--no-images",
                          "--config", str(train_config(cfg, root, name, f"log_{name}",
                                                       **training))])
        counts = ops.launch_counts()
        return (run, counts, load_checkpoint(root / f"log_{name}" / modes[stage]
                                             / f"ckpt-{DP_STEPS}"), time.perf_counter() - t0)

    # (a) world size 1 on NCCL through the env contract, against one process
    base = {stage: cli(stage, f"dp_base_s{stage}") for stage in (1, 2)}
    os.environ.update(KPVID_COORDINATOR=f"127.0.0.1:{free_port()}", KPVID_NUM_PROCESSES="1",
                      KPVID_PROCESS_ID="0")
    try:
        for stage in (1, 2):
            run, counts, ck, secs = cli(stage, f"dp_f32_s{stage}")
            _, base_counts, base_ck, base_secs = base[stage]
            want = {k: v * DP_STEPS + sweep[stage][k] for k, v in per_step[stage].items()}
            differ = [k for k in base_ck if not np.array_equal(base_ck[k], ck.get(k))]
            check(dist.is_initialized() and dist.get_backend() == "nccl"
                  and dist.get_world_size() == 1 and counts == base_counts == want
                  and sorted(ck) == sorted(base_ck) and not differ,
                  f"stage {stage} through the env contract on NCCL, world size 1, f32 reduce: "
                  f"{DP_STEPS} steps end with the single-process run's bits in all {len(ck)} "
                  f"arrays; launches {counts} (per step {per_step[stage]} and the sweep's); "
                  f"{secs:.1f} s against {base_secs:.1f} s")
            run16, counts16, ck16, _ = cli(stage, f"dp_bf16_s{stage}", dp_grad_dtype="bfloat16")
            gap = max(float(np.abs(ck16[k] - base_ck[k]).max()) for k in base_ck
                      if k.startswith(("stage", "discriminator", "image_discriminator")))
            check(all(np.isfinite(v) for v in run16["metrics"].values()) and counts16 == want
                  and gap > 0,
                  f"stage {stage}, bf16 reduce: {DP_STEPS} steps, every loss finite ("
                  + ", ".join(f"{k} {v:.4g}" for k, v in run16["metrics"].items())
                  + f"), parameters {gap:.3e} from the f32 run's ({gap / lr:.2f} lr)")
            rep[f"s{stage}_world1"] = {"seconds": secs, "seconds_single": base_secs,
                                       "bf16_gap_after_3": gap, "launches": counts}
            if stage == 1:
                rep["launches_dp_per_step"] = {k: (v - sweep[1][k]) / DP_STEPS
                                               for k, v in counts.items()}

        # one step, bf16 reduce against f32 (2.05 lr), then (e) the
        # collectives of one more profiled step of each
        vgg = synthesize_vgg19_params()
        for stage in (1, 2):
            steps, profiles = {}, {}
            for dt in ("single", "float32", "bfloat16"):  # "single": no process group's step
                c = dataclasses.replace(cfg, training=dataclasses.replace(
                    cfg.training, batch_size=DP_BATCH,
                    dp_grad_dtype="float32" if dt == "single" else dt))
                if dt == "single":
                    trainer = (Stage1Trainer(c, vgg, device=dev) if stage == 1
                               else Stage2Trainer(c, device=dev))
                    step = trainer.train_step
                else:
                    trainer, step = parallel.make_dp_reduce_step(c, stage, vgg_params=vgg)
                trainer.load_parameters(trainer.init_parameters(0))
                args = step_args(stage, inputs, slice(0, DP_BATCH), dev)
                step(*args)
                after = params_of(trainer)
                times = []
                for _ in range(6):  # the first is a warm-up
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(*args)
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    step(*args)
                    torch.cuda.synchronize()
                inv = parallel.collective_inventory(prof)
                kerns, host = profile_totals(prof)
                profiles[dt] = {
                    "device_ms": sum(us for _, us in kerns.values()) / 1e3,
                    "kernels": sum(n for n, _ in kerns.values()),
                    "collective_host_ms": sum(us for key, (_, us) in host.items()
                                              if key.startswith(("nccl:", "gloo:"))) / 1e3,
                    # each record: a same-name record nested in another
                    # counts too (key_averages() folds it)
                    "cpu_ops": sum(n for key, (n, _) in host.items()
                                   if key.startswith("aten::"))}
                steps[dt] = (after, inv, sum(p.numel() for p in trainer.model.parameters()),
                             float(np.median(times[1:])))
                del trainer, step
                torch.cuda.empty_cache()
            (p32, inv32, n_params, ms32), (p16, inv16, _, ms16) = (steps["float32"],
                                                                   steps["bfloat16"])
            p1, inv1, _, ms1 = steps["single"]
            check(inv1.total_ops == 0 and all(torch.equal(p1[k], p32[k]) for k in p32),
                  f"stage {stage}: the single-process step runs no collective, and the "
                  "data-parallel step at world size 1 with the f32 all-reduce gives its bits")
            print(f"stage {stage} step, bf16 compute, batch {DP_BATCH} (median of 5, host clock, "
                  f"synchronised): single process {ms1:.2f} ms; data-parallel at world size 1 "
                  f"(NCCL) {ms32:.2f} ms with the f32 all-reduce, {ms16:.2f} ms with the bf16 one; "
                  f"phase {6 + stage}'s step {base_step_ms.get(stage, float('nan')):.2f} ms; one "
                  "profiled step each (torch.profiler): " + "; ".join(
                      f"{dt}: device {p['device_ms']:.2f} ms over {p['kernels']} kernels, "
                      f"{p['cpu_ops']} aten ops, {p['collective_host_ms']:.2f} ms of host time in "
                      "the collectives' records" for dt, p in profiles.items()), flush=True)
            keys = [k for k in p32 if "running_" not in k]
            gap = max(float((p16[k] - p32[k]).abs().max()) for k in keys)
            check(0 < gap <= BF16_ENVELOPE_LR * lr,
                  f"stage {stage}, one step: bf16 reduce within {BF16_ENVELOPE_LR} lr of the f32 "
                  f"reduce (max {gap:.3e}, {gap / lr:.3f} lr) and not its bits")
            saved = inv32.total_bytes - inv16.total_bytes
            check(inv32.counts == inv16.counts and saved == 2 * n_params,
                  f"stage {stage} collectives per step (NCCL, world size 1): {inv32.counts} "
                  f"either way; {inv32.total_bytes / 1e6:.3f} MB in f32, "
                  f"{inv16.total_bytes / 1e6:.3f} MB in bf16: the gradients' "
                  f"{2 * n_params / 1e6:.3f} MB saved ({n_params} parameters)")
            rep[f"s{stage}_inventory"] = {
                "counts": inv32.counts, "bytes_f32": inv32.total_bytes,
                "bytes_bf16": inv16.total_bytes, "n_params": n_params,
                "bf16_gap_one_step": gap, "step_ms_f32": ms32, "step_ms_bf16": ms16,
                "step_ms_single_process": ms1, "step_ms_phase": base_step_ms.get(stage),
                "profiles": profiles}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for var in DP_ENV:
            os.environ.pop(var, None)

    # (c) grad_accum 2. Stage 2, f32: K = 2 against K = 1 on the same rows
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=DP_BATCH))
    runs = {}
    for k in (1, 2):
        c = dataclasses.replace(cfg32, training=dataclasses.replace(cfg32.training, grad_accum=k))
        t = Stage2Trainer(c, device=dev)
        t.load_parameters(t.init_parameters(1))
        kept = keep_reduced_grads(t)
        metrics = (t.train_step_accum if k > 1 else t.train_step)(
            *step_args(2, inputs, slice(0, DP_BATCH), dev))
        runs[k] = (params_of(t), {**kept[0], **kept[1]}, metrics)
    rep["s2_accum"] = s2_params_agree(runs[2][0], runs[1][0], runs[1][1], lr,
                                      "stage 2, f32, grad_accum 2 against 1")
    # stage 1, bf16: launches of #3 / #4 forward and backward K times a step; peak memory
    peaks = {}
    for k in (1, 2):
        c = dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, batch_size=DP_BATCH, grad_accum=k))
        t = Stage1Trainer(c, vgg, device=dev)
        t.load_parameters(t.init_parameters(0))
        args = step_args(1, inputs, slice(0, DP_BATCH), dev)
        fn = t.train_step_accum if k > 1 else t.train_step
        fn(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        metrics = fn(*args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peaks[k] = torch.cuda.max_memory_allocated() / 2**30
        want = {name: k * c_ for name, c_ in S1_PER_STEP.items()}
        check(counts == want and all(np.isfinite(float(v)) for v in metrics.values()),
              f"stage 1, bf16, batch {DP_BATCH}, grad_accum {k}: launches {counts} ({k} x "
              f"{S1_PER_STEP}), losses finite; peak memory {peaks[k]:.2f} GiB")
        if k == 2:
            rep["launches_accum_per_step"] = counts
        del t
        torch.cuda.empty_cache()
    rep["s1_peak_gib"] = peaks
    return rep


def dp_ranks_phase(cfg, card: str, root: Path, rep: dict) -> dict:
    """Phase 10 (b) + (d): two ranks sharing the card over gloo, against one
    process; the labeler and evaluate on two ranks. Adds to ``rep``, phase
    10's record, and prints it."""
    import torch

    from kpvid_tpu_torch import evaluate, ops
    from kpvid_tpu_torch.losses import synthesize_vgg19_params

    m = cfg.model
    lr = cfg.training.lr.start_val * cfg.training.lr.scale
    inputs = dp_inputs(cfg, root)
    vgg = synthesize_vgg19_params()
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=DP_BATCH))
    out = root / "dp_ranks"
    out.mkdir()
    np.savez(out / "s1_batch.npz", **inputs[1])
    np.savez(out / "s2_batch.npz", **inputs[2], noise=inputs["noise"])
    labels_before = {p.name: np.load(p) for p in (root / "penn" / "pseudo_labels").glob("*.npy")}
    conf = root / "eval.yaml"  # phase 9's
    ck2 = str(root / "log_a" / "motion_generator" / f"ckpt-{TRAIN_STEPS}")
    eval_args = ["--config", str(conf), "--checkpoint_stage1",
                 str(root / "log_s1" / "detector_translator"), "--checkpoint_stage2", ck2,
                 "--batch_size", "4"]
    job = {"s1_batch": str(out / "s1_batch.npz"), "s2_batch": str(out / "s2_batch.npz"),
           "label_args": ["--config", str(root / "cfg.yaml"), "--checkpoint",
                          str(root / "log_s1" / "detector_translator")],
           "evaluate_args": eval_args + ["--save_dir", str(root / "eval_dp2")]}
    t0 = time.perf_counter()
    infos = spawn_ranks(job, out, "--dp-rank-worker")
    spawn_s = time.perf_counter() - t0
    arrays = dict(np.load(out / "rank0.npz"))
    check([i["rank"] for i in infos] == [0, 1] and all(i["backend"] == "gloo" and i["world"] == 2
                                                        for i in infos)
          and infos[0]["s1_digest"] == infos[1]["s1_digest"]
          and infos[0]["s2_digest"] == infos[1]["s2_digest"],
          f"two ranks on the card over gloo ({spawn_s:.1f} s): both replicas end each step with "
          "the same bits")
    check(all(i["s1_launches"] == S1_PER_STEP and i["s2_launches"] == NO_LAUNCHES for i in infos),
          f"each rank's stage-1 step launched {infos[0]['s1_launches']}")
    for stage in (2, 1):
        after, want_g, metrics, _ = one_process_step(cfg32, stage, vgg, inputs)
        got_g = {k[len(f"s{stage}_grad/"):]: torch.from_numpy(v) for k, v in arrays.items()
                 if k.startswith(f"s{stage}_grad/")}
        got_p = {k[len(f"s{stage}_after/"):]: torch.from_numpy(v) for k, v in arrays.items()
                 if k.startswith(f"s{stage}_after/")}
        loss_gap = max(abs(infos[0][f"s{stage}_metrics"][k] - float(v)) / max(abs(float(v)), 1e-12)
                       for k, v in metrics.items())
        check(loss_gap <= STEP_LOSS_RTOL,
              f"stage {stage}, f32: 2 ranks x {DP_BATCH // 2} rows against one process at "
              f"{DP_BATCH}: losses within {STEP_LOSS_RTOL} (worst {loss_gap:.3e})")
        if stage == 2:
            rep["two_ranks_s2"] = s2_params_agree(got_p, after, want_g, lr,
                                                  "stage 2, 2 ranks against one process")
        else:
            rep["two_ranks_s1_grad_l2"] = s1_grads_agree(got_g, want_g,
                                                         "stage 1, 2 ranks (sync-BN) against "
                                                         "one process")
        rep[f"two_ranks_s{stage}_loss_gap"] = loss_gap
    rep["gloo_bf16"] = {w: infos[0][f"gloo_bf16_{w}"] for w in ("cuda", "cpu")}
    print(f"gloo's bf16 all-reduce: on the card {rep['gloo_bf16']['cuda']}; on the host "
          f"{rep['gloo_bf16']['cpu']}", flush=True)

    # (d) the labeler and evaluate on two ranks
    labels = {p.name: np.load(p) for p in (root / "penn" / "pseudo_labels").glob("*.npy")}
    label_gap = max(float(np.abs(labels[k] - labels_before[k]).max()) for k in labels_before)
    n_chunks = sum(i["label"]["chunks"] for i in infos)
    check(sorted(labels) == sorted(labels_before) and label_gap <= 1e-5
          and sum(i["label"]["videos"] for i in infos) == 32
          and all(i["label"]["launches"] == per_chunk(DETECT_LAUNCHES, i["label"]["chunks"])
                  for i in infos),
          f"the labeler on 2 ranks ({[i['label']['videos'] for i in infos]} videos, "
          f"{n_chunks} chunks, one pose_head each) writes the one-process labels of the same "
          f"checkpoint within 1e-5 (max {label_gap:.3e})")
    ops.reset_launch_counts()
    one = evaluate.main(eval_args + ["--save_dir", str(root / "eval_dp1")])
    got, want = tree_bytes(root / "eval_dp2"), tree_bytes(root / "eval_dp1")
    check(one["batches"] == 2 and [i["evaluate"]["batches"] for i in infos] == [1, 1]
          and all(i["evaluate"]["launches"] == generate_launches(i["evaluate"]["decodes"], 1,
                                                                 EVAL_LAUNCHES) for i in infos)
          and sorted(got) == sorted(want) and all(got[k] == want[k] for k in want)
          and len(want) == 8 * (2 + 5 * m.n_future_frames),
          "evaluate on 2 ranks at batch 4 (one batch each, 8 / 1 / 2 / 1 / 4 / 28 launches) "
          f"writes the one-process tree byte for byte ({len(want)} PNGs)")
    rep.update(spawn_seconds=spawn_s, label_gap=label_gap,
               rank_label=[i["label"] for i in infos], rank_evaluate=[i["evaluate"] for i in infos])
    print(f"dp on {card}: " + json.dumps({k: v for k, v in rep.items()
                                         if not k.startswith("rank_")}), flush=True)
    return rep


# phase 11 (interop): what the subprocess that imports a TF1 bundle runs
# first. TensorFlow is made unimportable (and its presence on the machine
# printed); the import must not need it.
NO_TF = ("import importlib.util, runpy, sys\n"
         "print('tensorflow installed on this machine:', "
         "importlib.util.find_spec('tensorflow') is not None, flush=True)\n"
         "sys.modules['tensorflow'] = None\n"
         "runpy.run_module('kpvid_tpu_torch.import_tf1_checkpoint', run_name='__main__', "
         "alter_sys=True)\n"
         "assert sys.modules['tensorflow'] is None\n")
IMPORT_STEP = 1000
CACHE_STEPS = 16
CACHE_MB = 256
CACHE_BLOCK = 256  # samples: one 16-step run at batch 16
CACHE_BLOCKS = 2  # four gave hit rates of 22 / 50 / 68 / 81% (PERF.md section 6)


def tf1_bundles(cfg, params, root: Path) -> dict:
    """Both stages' trainer weights from seed 0 at Config() (the generators'
    parameters, BN statistics included, those of ``params``; the stage-2
    encoder and both discriminators the trainers' init), named and laid out
    as the reference's TF1 checkpoints, written as TF bundles. Returns per
    stage the bundle's prefix, bytes, the mapped counts and the weights."""
    from kpvid_tpu_torch.bridge import to_flax_layout
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer
    from kpvid_tpu_torch.utils.tf1_import import map_names

    out = {}
    for stage, trainer in ((1, Stage1Trainer(cfg, synthesize_vgg19_params(max_width=8),
                                             device="cpu")),
                           (2, Stage2Trainer(cfg, device="cpu"))):
        weights = trainer.init_parameters(0)
        weights.update({k: v for k, v in params.items() if k in weights})
        tensors, counts = {"global_step": np.asarray(200000, np.int64)}, {}
        for part, prefix in (("", trainer.G_PREFIX), ("_discr", trainer.D_PREFIX)):
            names = [k for k in weights if k.startswith(prefix + ".")]
            mapping = map_names(names, f"stage{stage}{part}")
            counts[part or "_gen"] = len(mapping)
            tensors.update({tf: to_flax_layout(weights[k]) for k, tf in mapping.items()})
        prefix = root / f"tf1_stage{stage}" / "model.ckpt-200000"
        prefix.parent.mkdir()
        t0 = time.perf_counter()
        n_bytes = write_tf_bundle(prefix, tensors)
        out[stage] = {"prefix": prefix, "bytes": n_bytes, "tensors": len(tensors),
                      "generator": counts["_gen"], "discriminator": counts["_discr"],
                      "write_s": time.perf_counter() - t0}
    return out


def import_tf1(stage: int, bundle: dict, conf: Path, log_dir: Path, step: int) -> dict:
    """``python -m kpvid_tpu_torch.import_tf1_checkpoint`` in a process of
    its own with TensorFlow unimportable; checks every mapped tensor matched."""
    import re

    args = ["--config", str(conf), "--stage", str(stage), "--tf-checkpoint",
            str(bundle["prefix"]), "--log-dir", str(log_dir), "--step", str(step)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", NO_TF] + args, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode:
        print(out[-4000:], flush=True)
    m = re.search(r"transcoded (\d+) generator \+ (\d+) discriminator", out)
    tf_line = next((ln for ln in out.splitlines() if ln.startswith("tensorflow installed")), "")
    matched = (int(m.group(1)), int(m.group(2))) if m else None
    check(proc.returncode == 0 and matched == (bundle["generator"], bundle["discriminator"])
          and "absent from checkpoint" not in out and "shape mismatch" not in out,
          f"stage-{stage} TF1 import, TensorFlow unimportable ({tf_line}): matched "
          f"{matched} of {bundle['generator']} generator + {bundle['discriminator']} "
          f"discriminator tensors, none missing or mismatched, from a "
          f"{bundle['bytes'] / 1e6:.1f} MB bundle in {seconds:.2f} s")
    return {"seconds": seconds, "matched": matched, "missing": 0, "mismatched": 0,
            "bundle_bytes": bundle["bytes"], "bundle_tensors": bundle["tensors"],
            "bundle_write_s": bundle["write_s"], "tensorflow_line": tf_line}


def sample_seconds(root: Path, image_size: int) -> dict:
    """The host's seconds per stage-1 sample, one thread, with the cache over
    CACHE_BLOCKS blocks of fresh draws (the hit rate of each), between two
    blocks without it (before and after: the first block on a process pays
    for what warms up)."""
    from kpvid_tpu_torch.data import ImagePairDataset

    def run(ds, block: int) -> float:
        t0 = time.perf_counter()
        for i in range(CACHE_BLOCK):
            ds.sample(0, np.random.default_rng([7, block, i]))
        return (time.perf_counter() - t0) / CACHE_BLOCK

    plain = ImagePairDataset(str(root / "penn"), "train", image_size=image_size)
    cached = ImagePairDataset(str(root / "penn"), "train", image_size=image_size,
                              decode_cache_mb=CACHE_MB)
    out = {"plain_s": [run(plain, 0)], "blocks": []}
    for block in range(CACHE_BLOCKS):
        before = cached.cache.stats()
        secs = run(cached, block)
        after = cached.cache.stats()
        hits = after["hits"] - before["hits"]
        out["blocks"].append({"s_per_sample": secs, "hit_rate": hits / (2 * CACHE_BLOCK)})
    out["plain_s"].append(run(plain, CACHE_BLOCKS - 1))
    out["cache"] = cached.cache.stats()
    out["frames"] = sum(cached._n_frames(rel) for rel, _ in cached.videos)
    return out


def start_tf1_imports(cfg, params, root: Path) -> dict:
    """Phase 11 (a)'s start, on threads of this process: both TF1 bundles
    written, then both imports at once, each in a process of its own (and
    its own checkpoint directory); :func:`interop_phase` collects them."""
    conf = train_config(cfg, root, "s2_import", "log_import")
    pool = ThreadPoolExecutor(3)
    bundles = pool.submit(tf1_bundles, cfg, params, root)

    def run(stage: int, step: int) -> dict:
        return import_tf1(stage, bundles.result()[stage], conf, root / "log_import", step)

    futures = {stage: pool.submit(run, stage, step) for stage, step in ((1, 0), (2, IMPORT_STEP))}
    pool.shutdown(wait=False)
    return {"bundles": bundles, "conf": conf, "futures": futures}


def interop_phase(cfg, params, card: str, root: Path, imports: dict) -> dict:
    """Phase 11: the TF1 import at Config() (``imports``: from
    :func:`start_tf1_imports`) and stage 1's frame cache, profiler and
    TensorBoard."""
    import importlib

    import torch

    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.checkpoint import load_checkpoint
    from kpvid_tpu_torch.eval import FinalGenerator, request_z
    from kpvid_tpu_torch.serve import load_generator_parameters
    from kpvid_tpu_torch.train import main as train_main
    from kpvid_tpu_torch.train.state import GANTrainer, make_lr_schedule

    m = cfg.model
    rep = {}
    # (a) TF1 bundles -> the import CLI -> generate, and stage 2 trains on
    bundles, conf = imports["bundles"].result(), imports["conf"]
    for stage, done in imports["futures"].items():
        rep[f"import_stage{stage}"] = done.result()
    imported = root / "log_import"
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(load_generator_parameters(
        gen.model.state_dict(), str(imported / "detector_translator"),
        str(imported / "motion_generator")))
    direct = FinalGenerator(cfg, device="cuda")
    direct.load_parameters(params)
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (BATCH, m.image_size, m.image_size, 3)).astype(np.float32)
    act = np.eye(m.n_action, dtype=np.float32)[[2, 4, 6, 8]]
    z = np.stack([request_z(seed, m.vae_dim) for seed in (31, 32, 33, 34)])
    want = direct.generate(images, act, z)
    with decode_paths() as paths:
        ops.reset_launch_counts()
        got = gen.generate(images, act, z)
        counts = ops.launch_counts()
    same = [k for k in want if torch.equal(got[k], want[k])]
    check(counts == generate_launches(paths, 1) and len(same) == len(want),
          f"generate from the two imported checkpoints: the bits of the seed-0 parameters "
          f"loaded directly in {len(same)} of {len(want)} outputs, launches {counts} "
          f"(decodes: {paths})")
    rep["generate_launches"] = counts

    rates = []
    apply = GANTrainer._apply

    def recording_apply(self, opt, params_, grads):
        apply(self, opt, params_, grads)
        rates.append(opt.param_groups[0]["lr"])

    with mock.patch.object(GANTrainer, "_apply", recording_apply):
        run = train_main(["--mode", "motion_generator", "--no-images", "--config", str(conf),
                          "--max-steps", str(IMPORT_STEP + 3)])
    lr = make_lr_schedule(cfg.training.lr)
    arrays = load_checkpoint(imported / "motion_generator" / f"ckpt-{IMPORT_STEP + 3}")
    check(run["start_step"] == IMPORT_STEP and int(arrays["step"]) == IMPORT_STEP + 3
          and all(np.isfinite(v) for v in run["metrics"].values())
          and rates[:2] == [lr(0), lr(0)] and rates[2:] == [lr(1), lr(1), lr(2), lr(2)]
          and lr(0) != lr(IMPORT_STEP),
          f"3 stage-2 steps from the imported ckpt-{IMPORT_STEP}: losses finite ("
          + ", ".join(f"{k} {v:.4g}" for k, v in run["metrics"].items())
          + f"); the first update's rate {rates[0]:.6g} = lr(0), not lr({IMPORT_STEP}) = "
          f"{lr(IMPORT_STEP):.6g}")
    rep["train_after_import"] = {"rates": rates, "metrics": run["metrics"]}

    # (b) 16 stage-1 steps with the frame cache, the profiler and TensorBoard,
    # and the same 16 without them
    try:
        importlib.import_module("torch.utils.tensorboard")
        tensorboard = True
    except ImportError as e:
        tensorboard = False
        print(f"torch.utils.tensorboard does not import here ({e}): the cached run goes "
              "without --tensorboard", flush=True)
    # (the 16 steps with the cache alone and without it in turns showed that
    # the cache does not move the wall, PERF.md section 6; no longer run)
    runs, launches = {}, {}
    for name, data, flags in (
            ("cached", {"decode_cache_mb": CACHE_MB},
             ["--profile-dir", str(root / "prof")] + (["--tensorboard"] if tensorboard else [])),
            ("plain", {}, [])):
        conf1 = train_config(cfg, root, f"s1_{name}", f"log_s1_{name}", data=data)
        ops.reset_launch_counts()
        runs[name] = train_main(["--mode", "detector_translator", "--no-images", "--max-steps",
                                 str(CACHE_STEPS), "--config", str(conf1)] + flags)
        launches[name] = ops.launch_counts()
    want_counts = {k: c * CACHE_STEPS for k, c in S1_PER_STEP.items()}
    want_counts["pose_head"] += 1  # the test sweep at step 0: one batch's forward
    want_counts["gaussian_render"] += 2
    want_counts["bias_bn_relu"] += S1_INFERENCE_BN
    a, b = (load_checkpoint(root / f"log_s1_{n}" / "detector_translator" / f"ckpt-{CACHE_STEPS}")
            for n in ("cached", "plain"))
    differ = [k for k in b if not np.array_equal(a.get(k), b[k])]
    check(launches["cached"] == launches["plain"] == want_counts and sorted(a) == sorted(b)
          and not differ,
          f"{CACHE_STEPS} stage-1 steps with the frame cache ({CACHE_MB} MB), --profile-dir"
          f"{' and --tensorboard' if tensorboard else ''} end with the plain run's bits in all "
          f"{len(b)} arrays; launches {launches['cached']}: 1 / 2 forward and 1 / 2 backward "
          "#3 / #4 a step, plus the test sweep's forward")
    trace = runs["cached"]["profile_trace"]
    events = json.loads(Path(trace).read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    ours = {k: sum(k in n for n in kernels) for k in
            ("pose_head_kernel", "gaussian_render_kernel", "pose_head_backward_kernel",
             "render_backward_kernel")}
    check(all(ours.values()),
          f"the profiler trace of steps 10-14 ({Path(trace).stat().st_size / 1e6:.1f} MB, "
          f"{len(kernels)} kernel events) holds the kpvid kernels: {ours}")
    tb_files = sorted((root / "log_s1_cached" / "detector_translator").glob("*/events.out*"))
    if tensorboard:
        check(len(tb_files) >= 2 and all(f.stat().st_size > 0 for f in tb_files),
              f"--tensorboard wrote {len(tb_files)} event files (train and test)")
    cache = runs["cached"]["frame_cache"]
    walls = {n: runs[n]["seconds"] for n in ("cached", "plain")}
    host = sample_seconds(root, m.image_size)
    print(f"interop on {card}: imports {rep['import_stage1']['seconds']:.2f} s (stage 1, "
          f"{bundles[1]['bytes'] / 1e6:.1f} MB) and {rep['import_stage2']['seconds']:.2f} s "
          f"(stage 2, {bundles[2]['bytes'] / 1e6:.1f} MB); the 16-step cached run's cache: "
          f"{cache} (hit rate {cache['hits'] / max(cache['hits'] + cache['misses'], 1):.3f}); "
          f"16 steps (step 0's test sweep included) {runs['cached']['seconds']:.2f} s with the "
          f"cache, profiler and TensorBoard, {walls['plain']:.2f} s without them"
          + "; host s per sample, one thread: plain (before and after) "
          + " / ".join(f"{1e3 * v:.3f}" for v in host["plain_s"]) + " ms, cached "
          + ", ".join(f"block {i} {1e3 * blk['s_per_sample']:.3f} ms (hits "
                      f"{blk['hit_rate']:.3f})" for i, blk in enumerate(host["blocks"]))
          + f" over {host['frames']} frames; trace {Path(trace).stat().st_size} bytes; "
          f"TensorBoard {'on' if tensorboard else 'off'}", flush=True)
    rep.update({"stage1_cached": {"frame_cache": cache, "seconds": runs["cached"]["seconds"],
                                  "seconds_plain": walls["plain"],
                                  "launches_per_step": dict(S1_PER_STEP),
                                  "trace_bytes": Path(trace).stat().st_size,
                                  "trace_kernel_events": len(kernels), "trace_ours": ours,
                                  "tensorboard": tensorboard,
                                  "tensorboard_files": len(tb_files)},
                "host_sample": host})
    return rep


# phase 12 (tp_mesh): tensor parallelism at 1x2 on the card, and one process
# over several replicas (--mesh)
TP_STEPS = 3  # the stage-2 CLI's steps at 1x2
TP_TIMED = 3  # host-clock steps of each stage after the compared one (median)
MESH_TIMED = 5  # host-clock runs of each engine at batch 32 (median)
EVAL_DELAY_CYCLES = 200_000_000  # ~0.1 s of spinning on a replica's stream
F1_SPIN_CYCLES = 1_000_000_000  # ~0.5 s: well above two replicas' host time at Config()
F1_FRAMES = 4  # future frames of the F1 check's generate
# stage 2 at 1x2: a first Adam step may turn over where |g| is below this
# share of its tensor's max |g| (s2_tp_agree)
TP_SIGN_STEP_REL = 1e-5


def median_ms(fn, n: int) -> float:
    """The median host-clock ms of ``n`` calls of ``fn``, each synchronised."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def s2_tp_agree(got_p: dict, want_p: dict, got_g: dict, want_g: dict, lr: float,
                what: str) -> dict:
    """Stage 2 at 1x2 against one process: phase 10's rule with a sign-step
    threshold relative to each tensor's largest gradient. Every parameter
    within DP_S2_PARAM_ATOL, but where its first-step gradient is below
    TP_SIGN_STEP_REL of its tensor's max |g|, within 2.05 lr: there the
    first Adam step (lr * sign(g)) may turn over. The column-parallel LSTM
    sums each cell step's input gradient from two partial products, so every
    backward step of the recurrence rounds in another order than one product
    does, and the encoder's ill-conditioned gradients carry it further than
    the data-parallel step's one reduction: the turned-over steps lie above
    phase 10's absolute 1e-6. Each gradient is also held within
    STEP_GRAD_REL of its tensor's max |g| (phase 8's rule)."""
    worst_p, beyond, worst_g, flip_g = 0.0, 0, {}, 0.0
    for k, g in want_g.items():
        diff = (got_p[k] - want_p[k]).abs()
        worst_p = max(worst_p, float(diff.max()))
        out = diff > DP_S2_PARAM_ATOL
        beyond += int(out.sum())
        gmax = max(float(g.abs().max()), 1e-30)
        if bool(out.any()):
            flip_g = max(flip_g, float(g.abs()[out].max()) / gmax)
        sign = g.abs() < TP_SIGN_STEP_REL * gmax
        if bool((out & ~sign).any()) or bool((diff[out] > 2.05 * lr).any()):
            raise CheckFailed(f"{what}: {k} differs by {float(diff.max()):.3e}, beyond "
                              f"{DP_S2_PARAM_ATOL} where |g| is not below {TP_SIGN_STEP_REL} of "
                              "its tensor's max (or beyond 2.05 lr)")
        worst_g[k] = float((got_g[k] - g).abs().max()) / gmax
    k_g = max(worst_g, key=worst_g.get)
    check(worst_g[k_g] <= STEP_GRAD_REL,
          f"{what}: every parameter within {DP_S2_PARAM_ATOL} (worst {worst_p:.3e}); {beyond} "
          f"elements beyond it, all sign steps within 2.05 lr at |g| below {TP_SIGN_STEP_REL} of "
          f"their tensor's max (largest {flip_g:.3e}); each gradient within {STEP_GRAD_REL} of "
          f"its max (worst {worst_g[k_g]:.3e}, {k_g})")
    return {"worst": worst_p, "beyond": beyond, "beyond_max_grad_rel": flip_g,
            "grad_rel": worst_g[k_g]}


def tp_rank_worker(job_path: str) -> int:
    """One rank of phase 12's 1x2 mesh, two ranks sharing the card over
    gloo. For each stage: one f32 step at Config() on all 16 rows (the two
    'model' ranks of the data coordinate see the same rows) from
    ``init_parameters(1)``; each sharded array's local slice against its
    slice of the gathered arrays; the rank's parameter and Adam bytes;
    TP_TIMED timed steps and one profiled (the collectives). Then the
    stage-2 CLI with --mesh-model 2. Rank 0 writes the gathered parameters
    after the first step and the gathered gradients of its updates
    (rank0.npz); each rank its record (rank{r}.json)."""
    import hashlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kpvid_tpu_torch import ops, parallel
    from kpvid_tpu_torch.configs import Config
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import main as train_main
    from kpvid_tpu_torch.train.state import optimizer_arrays

    job = json.loads(Path(job_path).read_text())
    out = Path(job["out"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    parallel.maybe_initialize("cuda")
    rank, world = parallel.world()
    mesh = parallel.make_mesh(n_model=world)
    cfg = Config().validate()
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=DP_BATCH))
    inputs = {1: dict(np.load(job["s1_batch"])), 2: dict(np.load(job["s2_batch"]))}
    inputs["noise"] = inputs[2].pop("noise")
    arrays, info = {}, {"rank": rank, "world": world, "coords": [mesh.d, mesh.m]}
    for stage in (2, 1):
        vgg = synthesize_vgg19_params() if stage == 1 else None
        trainer, step = parallel.make_dp_reduce_step(cfg32, stage, mesh, vgg)
        trainer.load_parameters(trainer.init_parameters(1))
        kept = keep_reduced_grads(trainer)
        args = step_args(stage, inputs, slice(0, DP_BATCH), trainer.device)
        ops.reset_launch_counts()
        metrics = step(*args)
        launches = ops.launch_counts()
        full = {k: v.detach().cpu().clone() for k, v in trainer.state_arrays().items()}
        grads = parallel.gather_state({**kept[0], **kept[1]}, trainer.param_rules,
                                      trainer.shard)
        local = {**trainer.model.state_dict(),
                 **optimizer_arrays(trainer.g_opt, trainer._g_names, f"g_opt.{trainer.G_PREFIX}"),
                 **optimizer_arrays(trainer.d_opt, trainer._d_names, f"d_opt.{trainer.D_PREFIX}")}
        shards = {k: [mesh.m, list(local[k].shape), list(full[k].shape),
                      bool(torch.equal(trainer.shard.local(full[k], dim), local[k].cpu()))]
                  for k, dim in trainer.array_rules.items()}
        names = list(trainer.model.state_dict())
        moments = [k for k in local if k.endswith((".exp_avg", ".exp_avg_sq"))]
        rec = {
            "metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches,
            "shards": shards, "rules": len(trainer.array_rules),
            "digest": hashlib.sha256(b"".join(full[k].numpy().tobytes()
                                              for k in sorted(full))).hexdigest(),
            "param_bytes": sum(4 * p.numel() for p in trainer.model.parameters()),
            "adam_bytes": sum(4 * local[k].numel() for k in moments),
            "param_bytes_full": sum(4 * full[k].numel() for k in names
                                    if not k.endswith(("running_mean", "running_var"))),
            "adam_bytes_full": sum(4 * full[k].numel() for k in moments),
        }
        rec["step_ms"] = median_ms(lambda: step(*args), TP_TIMED)
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            step(*args)
            torch.cuda.synchronize()
        inv = parallel.collective_inventory(prof)
        rec["inventory"] = {"counts": inv.counts, "bytes": inv.bytes, "dtypes": inv.dtypes}
        info[f"s{stage}"] = rec
        if rank == 0:
            arrays.update({f"s{stage}_after/{k}": full[k].float().numpy() for k in names})
            arrays.update({f"s{stage}_grad/{k}": v.numpy() for k, v in grads.items()})
        del trainer, step, kept, full, grads, local
        torch.cuda.empty_cache()
    ops.reset_launch_counts()
    run = train_main(job["cli_args"])
    info["cli"] = {"start_step": run["start_step"], "end_step": run["end_step"],
                   "metrics": run["metrics"], "launches": ops.launch_counts(),
                   "seconds": run["seconds"]}
    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(info))
    return 0


def one_process_step(cfg32, stage: int, vgg, inputs: dict, timed: int = 0):
    """The single-process trainer's f32 step from ``init_parameters(1)`` on
    the 16 rows: (parameters after it, its reduced gradients, metrics, the
    median ms of ``timed`` more steps or None)."""
    import torch

    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer

    dev = torch.device("cuda")
    t = Stage1Trainer(cfg32, vgg, device=dev) if stage == 1 else Stage2Trainer(cfg32, device=dev)
    t.load_parameters(t.init_parameters(1))
    kept = keep_reduced_grads(t)
    args = step_args(stage, inputs, slice(0, DP_BATCH), dev)
    metrics = t.train_step(*args)
    after = params_of(t)
    ms = median_ms(lambda: t.train_step(*args), timed) if timed else None
    del t
    torch.cuda.empty_cache()
    return after, {**kept[0], **kept[1]}, metrics, ms


def evaluate_launch_check(cfg, params, card: str) -> dict:
    """evaluate's launch over two replicas on the card queues its work with no
    wait on the host: with a spin kernel queued first on replica 0's stream,
    map() returns while that stream still runs (a host array copied to the
    card inside the launch would wait for it, and the replicas would run one
    after another). Four future frames keep the launches queued behind the
    spin below the CUDA queue of pending launches on a stream, past which
    any launch waits on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kpvid_tpu_torch import evaluate
    from kpvid_tpu_torch.eval.final import GeneratorMesh
    from kpvid_tpu_torch.utils import get_n_colors

    dev = torch.device("cuda", 0)
    m = dataclasses.replace(cfg.model, n_future_frames=F1_FRAMES)
    mesh = GeneratorMesh(dataclasses.replace(cfg, model=m), params, [dev, dev])
    launch = evaluate.make_launch(get_n_colors(m.n_pts))
    rng = np.random.default_rng(12)
    rows = (rng.uniform(-1, 1, (BATCH, m.image_size, m.image_size, 3)).astype(np.float32),
            np.eye(m.n_action, dtype=np.float32)[np.arange(BATCH) % m.n_action],
            rng.standard_normal((BATCH, m.vae_dim)).astype(np.float32))
    mesh.map(launch, *rows)
    mesh.synchronize()
    stream = mesh.replicas[0].stream
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        start.record()
        torch.cuda._sleep(F1_SPIN_CYCLES)
        end.record()
    t0 = time.perf_counter()
    mesh.map(launch, *rows)
    host_ms = 1e3 * (time.perf_counter() - t0)
    busy = not stream.query()
    mesh.synchronize()
    spin_ms = start.elapsed_time(end)
    check(busy and host_ms < 0.5 * spin_ms,
          f"evaluate's launch over two replicas at batch {BATCH}, {F1_FRAMES} future frames, on "
          f"{card}: map() returned in {host_ms:.2f} ms with replica 0's stream still busy "
          f"({busy}) behind a spin of {spin_ms:.2f} ms queued first")
    rec = {"evaluate_launch_host_ms": host_ms, "evaluate_launch_spin_ms": spin_ms}
    # why four frames: the device work one replica's launch queues, at four
    # frames and at Config()'s, and the host's time for n launches queued on a
    # stream behind the same spin
    for frames in (F1_FRAMES, cfg.model.n_future_frames):
        one = GeneratorMesh(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, n_future_frames=frames)), params, [dev])
        one.map(launch, *rows)
        one.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one.map(launch, *rows)
            one.synchronize()
        rec[f"device_ops_{frames}_frames"] = sum(
            n for _, n, _ in device_records(prof))
        del one
    x = torch.zeros(1, device=dev)
    side = torch.cuda.Stream()
    for n in (500, 1500):
        with torch.cuda.stream(side):
            torch.cuda._sleep(F1_SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(n):
                x.add_(1)
            rec[f"host_ms_{n}_launches_behind_spin"] = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
    print(f"evaluate's launch on {card}: {json.dumps(rec)}", flush=True)
    return rec


def tp_mesh_phase(cfg, params, card: str, root: Path) -> dict:
    """Phase 12: tensor parallelism at 1x2 (two gloo ranks sharing the card)
    against one process, the stage-2 CLI at 1x2 and its checkpoint resumed
    in one process; then one process over several replicas: the mesh engine
    over two replicas on the card and over the default list, bench with and
    without --mesh, evaluate --mesh and serve --mesh."""
    import shutil

    import torch

    from kpvid_tpu_torch import bench, ops
    from kpvid_tpu_torch.checkpoint import load_checkpoint
    from kpvid_tpu_torch.eval import FinalGenerator, InferenceEngine
    from kpvid_tpu_torch.eval import final as final_mod
    from kpvid_tpu_torch.eval.server import one_hot, serve_outputs
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.serve import load_generator_parameters
    from kpvid_tpu_torch.train import main as train_main

    m = cfg.model
    lr = cfg.training.lr.start_val * cfg.training.lr.scale
    rep = {}

    # (a) two ranks at 1x2, one f32 step of each stage against one process
    inputs = dp_inputs(cfg, root)
    out = root / "tp_ranks"
    out.mkdir()
    np.savez(out / "s1_batch.npz", **inputs[1])
    np.savez(out / "s2_batch.npz", **inputs[2], noise=inputs["noise"])
    conf = train_config(cfg, root, "tp_s2", "log_tp")
    job = {"s1_batch": str(out / "s1_batch.npz"), "s2_batch": str(out / "s2_batch.npz"),
           "cli_args": ["--mode", "motion_generator", "--max-steps", str(TP_STEPS),
                        "--no-images", "--mesh-model", "2", "--config", str(conf)]}
    t0 = time.perf_counter()
    infos = spawn_ranks(job, out, "--tp-rank-worker")
    spawn_s = time.perf_counter() - t0
    arrays = dict(np.load(out / "rank0.npz"))
    check([i["coords"] for i in infos] == [[0, 0], [0, 1]]
          and all(infos[0][f"s{st}"]["digest"] == infos[1][f"s{st}"]["digest"] for st in (1, 2)),
          f"two ranks at 1x2 on the card over gloo ({spawn_s:.1f} s): mesh coordinates (0, 0) "
          "and (0, 1); both end each step with the same bits in every gathered array")
    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=DP_BATCH))
    vgg = synthesize_vgg19_params()
    for stage in (2, 1):
        r0, r1 = (i[f"s{stage}"] for i in infos)
        sh = {k: (r0["shards"][k], r1["shards"][k]) for k in r0["shards"]}
        check(len(sh) == r0["rules"] == (12 if stage == 1 else 36)
              and all(a[0] == 0 and b[0] == 1 and a[3] and b[3] and a[1] == b[1]
                      and int(np.prod(a[1])) * 2 == int(np.prod(a[2])) for a, b in sh.values()),
              f"stage {stage}: each rank holds its own half of the {len(sh)} sharded arrays "
              "(parameters and Adam moments), and the halves join to the single-process layout")
        want = {1: S1_PER_STEP, 2: NO_LAUNCHES}[stage]
        check(r0["launches"] == r1["launches"] == want,
              f"stage {stage}, each rank's step launched {r0['launches']}")
        after, want_g, metrics, ms1 = one_process_step(cfg32, stage, vgg, inputs, TP_TIMED)
        got_g = {k[len(f"s{stage}_grad/"):]: torch.from_numpy(v) for k, v in arrays.items()
                 if k.startswith(f"s{stage}_grad/")}
        got_p = {k[len(f"s{stage}_after/"):]: torch.from_numpy(v) for k, v in arrays.items()
                 if k.startswith(f"s{stage}_after/")}
        loss_gap = max(abs(r0["metrics"][k] - float(v)) / max(abs(float(v)), 1e-12)
                       for k, v in metrics.items())
        check(loss_gap <= STEP_LOSS_RTOL and sorted(got_p) == sorted(after),
              f"stage {stage}, f32, 16 rows at 1x2 against one process: losses within "
              f"{STEP_LOSS_RTOL} (worst {loss_gap:.3e})")
        if stage == 2:
            agree = s2_tp_agree(got_p, after, got_g, want_g, lr,
                                "stage 2 at 1x2 against one process")
        else:
            agree = s1_grads_agree(got_g, want_g, "stage 1 at 1x2 against one process")
        inv = [i[f"s{stage}"]["inventory"] for i in infos]
        print(f"stage {stage} at 1x2, f32, batch {DP_BATCH} (host clock, synchronised, median of "
              f"{TP_TIMED}): {r0['step_ms']:.2f} / {r1['step_ms']:.2f} ms a step on ranks 0 / 1 "
              f"(gloo, sharing the card) against {ms1:.2f} ms in one process; collectives per "
              f"step and rank: {inv[0]['counts']}, {sum(inv[0]['bytes'].values()) / 1e6:.3f} MB "
              f"({inv[0]['bytes']}, dtypes {inv[0]['dtypes']}); a rank holds "
              f"{r0['param_bytes'] / 1e6:.3f} MB of parameters and {r0['adam_bytes'] / 1e6:.3f} "
              f"MB of Adam moments, against {r0['param_bytes_full'] / 1e6:.3f} MB and "
              f"{r0['adam_bytes_full'] / 1e6:.3f} MB whole", flush=True)
        rep[f"s{stage}"] = {"agree": agree, "loss_gap": loss_gap, "step_ms_ranks":
                            [r0["step_ms"], r1["step_ms"]], "step_ms_one_process": ms1,
                            "inventory_per_rank": inv[0], "launches_per_rank": r0["launches"],
                            **{k: r0[k] for k in ("param_bytes", "adam_bytes", "param_bytes_full",
                                                  "adam_bytes_full", "rules")}}
    rep["launches_tp_per_step"] = infos[0]["s1"]["launches"]
    rep["spawn_s"] = spawn_s

    # (b) the stage-2 CLI at 1x2, its full ckpt-3 resumed in one process
    cli = [i["cli"] for i in infos]
    tp_dir = root / "log_tp" / "motion_generator"
    ck = load_checkpoint(tp_dir / f"ckpt-{TP_STEPS}")
    ref = load_checkpoint(root / "log_a" / "motion_generator" / f"ckpt-{TRAIN_STEPS}")
    check(all(c["end_step"] == TP_STEPS and c["launches"] == NO_LAUNCHES
              and all(np.isfinite(v) for v in c["metrics"].values()) for c in cli)
          and sorted(ck) == sorted(ref) and all(ck[k].shape == ref[k].shape for k in ref)
          and int(ck["step"]) == TP_STEPS,
          f"the stage-2 CLI at 1x2 (--mesh-model 2, bf16, batch {TRAIN_BATCH}): {TP_STEPS} steps, "
          "losses finite (" + ", ".join(f"{k} {v:.4g}" for k, v in cli[0]["metrics"].items())
          + f"), no kernel launched on either rank; ckpt-{TP_STEPS} holds all {len(ck)} arrays "
          f"at their full shapes ({cli[0]['seconds']:.1f} s)")
    one_dir = root / "log_tp1" / "motion_generator"
    one_dir.mkdir(parents=True)
    shutil.copytree(tp_dir / f"ckpt-{TP_STEPS}", one_dir / f"ckpt-{TP_STEPS}")
    run = train_main(["--mode", "motion_generator", "--max-steps", str(TP_STEPS + 1),
                      "--no-images", "--config", str(train_config(cfg, root, "tp_s2_one",
                                                                  "log_tp1"))])
    after = load_checkpoint(one_dir / f"ckpt-{TP_STEPS + 1}")
    check(run["start_step"] == TP_STEPS and int(after["step"]) == TP_STEPS + 1
          and all(np.isfinite(v) for v in run["metrics"].values()),
          f"the 1x2 ckpt-{TP_STEPS} resumed in one process: step {TP_STEPS} to {TP_STEPS + 1}, "
          "losses finite")
    rep["cli"] = {"metrics": cli[0]["metrics"], "seconds": [c["seconds"] for c in cli],
                  "resumed_metrics": run["metrics"]}

    # (c) one process over several replicas: the mesh engine at batch 32
    dev = torch.device("cuda", 0)
    b, half = BATCH_B32, BATCH_B32 // 2
    rng = np.random.default_rng(6)
    images = rng.uniform(-1, 1, (b, m.image_size, m.image_size, 3)).astype(np.float32)
    actions = rng.integers(0, m.n_action, b)
    z = rng.standard_normal((b, m.vae_dim)).astype(np.float32)
    gen = FinalGenerator(cfg, device="cuda")
    gen.load_parameters(params)

    def direct(rows: slice) -> dict:
        """generate on the default stream, read back there: no engine."""
        return {k: v.cpu().numpy() for k, v in serve_outputs(gen.generate(
            images[rows], one_hot(actions[rows], m.n_action), z[rows])).items()}

    want = direct(slice(None))
    halves = [direct(slice(i * half, (i + 1) * half)) for i in range(2)]
    del gen
    engines = {"one_engine": None, "default": final_mod.mesh_devices("cuda"),
               "two_replicas": [dev, dev]}
    mesh_rep = {}
    for name, devices in engines.items():
        eng = InferenceEngine(cfg, params, devices=devices)
        eng.run(images, actions, z)  # warm-up: cuDNN's choices on the replicas' streams
        with decode_paths() as paths:
            ops.reset_launch_counts()
            got = eng.run(images, actions, z)
            counts = ops.launch_counts()
        n = eng.n_data
        where = "the one device" if devices is None else [str(d) for d in devices]
        check(counts == generate_launches(paths, n),
              f"engine over {where}: launches {counts}, 8 / 1 / 2 / 1 / 2 / 28 per replica "
              f"batch of {b // n} (decodes: {paths})")
        if n == 1:
            same = [k for k in want if np.array_equal(got[k], want[k])]
            check(len(same) == len(want), f"engine over {where} ({n} replica): the bits of "
                                          "generate on the default stream in "
                                          f"{len(same)} of {len(want)} outputs")
        else:
            same = all(np.array_equal(got[k][i * half:(i + 1) * half], halves[i][k])
                       for i in range(2) for k in want)
            check(same, "mesh engine over two replicas on one card: each replica's 16 rows are "
                        "generate's bits at batch 16")
            mesh_rep["two_replicas_vs_batch32"] = check_bucket_agreement(
                got, want, "two replicas against generate at batch 32")
            check(True, f"two replicas against generate at batch 32 within the bucket bounds: "
                        f"{mesh_rep['two_replicas_vs_batch32']}")
        mesh_rep[f"{name}_ms"] = median_ms(lambda: eng.run(images, actions, z), MESH_TIMED)
        mesh_rep[f"{name}_launches"] = counts
        del eng
    print(f"mesh engine, batch {b}, bf16 (host clock, synchronised, median of {MESH_TIMED}) on "
          f"{card}: one engine {mesh_rep['one_engine_ms']:.2f} ms, mesh over the default list "
          f"{mesh_rep['default_ms']:.2f} ms, two replicas on one card "
          f"{mesh_rep['two_replicas_ms']:.2f} ms", flush=True)
    rep["mesh"] = mesh_rep
    rep["mesh_launches_per_replica"] = {k: v / 2 for k, v in
                                        mesh_rep["two_replicas_launches"].items()}
    del halves
    torch.cuda.empty_cache()

    # bench with and without --mesh (the default list), and --mesh over two replicas
    benches = {"single": bench.main([]), "mesh": bench.main(["--mesh"])}
    with mock.patch.object(final_mod, "mesh_devices", lambda device: [dev, dev]):
        benches["mesh_two_replicas"] = bench.main(["--mesh"])
    check(all(r["value"] > 0 and r["batch"] == BATCH_B32 for r in benches.values())
          and benches["mesh"]["n_data"] == torch.cuda.device_count()
          and benches["mesh_two_replicas"]["n_data"] == 2,
          "python -m kpvid_tpu_torch.bench: " + ", ".join(
              f"{k} {r['value']} frames/s ({r['n_data']} replica(s))" for k, r in benches.items()))
    rep["bench"] = benches
    rep.update(evaluate_launch_check(cfg, params, card))

    # serve --mesh in a process of its own, warming up while evaluate --mesh
    # (the default list) writes phase 9's tree
    ck2 = str(root / "log_a" / "motion_generator" / f"ckpt-{TRAIN_STEPS}")
    s1_dir = str(root / "log_s1" / "detector_translator")
    daemon = start_daemon(["--config", str(root / "eval.yaml"), "--checkpoint_stage1", s1_dir,
                           "--checkpoint_stage2", ck2, "--mesh", "--buckets",
                           *map(str, ARTIFACT_BUCKETS)], "serve --mesh", root)
    try:
        rep.update(evaluate_mesh_checks(root, s1_dir, ck2))
        gen = FinalGenerator(cfg, device="cpu")
        engine = InferenceEngine(cfg, load_generator_parameters(gen.model.state_dict(), s1_dir,
                                                                ck2), device="cuda")
        rep["serve_mesh"] = finish_daemon(daemon, m, ARTIFACT_BUCKETS, engine)
    finally:
        stop_daemon(daemon)
    print(f"tp_mesh on {card}: " + json.dumps({k: v for k, v in rep.items()
                                               if not k.startswith("launches")}), flush=True)
    return rep


def evaluate_mesh_checks(root: Path, s1_dir: str, ck2: str) -> dict:
    """evaluate --mesh over the default list writes phase 9's tree; over two
    replicas on the card its readbacks wait for each replica's stream."""
    import torch

    from kpvid_tpu_torch import evaluate, ops
    from kpvid_tpu_torch.eval import FinalGenerator
    from kpvid_tpu_torch.eval import final as final_mod

    dev = torch.device("cuda", 0)
    rep = {}
    with decode_paths() as paths:
        ops.reset_launch_counts()
        stats = evaluate.main(["--config", str(root / "eval.yaml"), "--checkpoint_stage1",
                               s1_dir, "--checkpoint_stage2", ck2, "--save_dir",
                               str(root / "eval_mesh"), "--mesh"])
        counts = ops.launch_counts()
    got, want = tree_bytes(root / "eval_mesh"), tree_bytes(root / "eval_a")
    check(stats["batches"] == 1 and counts == generate_launches(paths, 1, EVAL_LAUNCHES)
          and sorted(got) == sorted(want) and all(got[k] == want[k] for k in want),
          f"evaluate --mesh over the default list writes phase 9's tree byte for byte "
          f"({len(want)} PNGs), launches {counts} (decodes: {paths})")
    rep["evaluate_mesh_s"] = stats["seconds"]

    # evaluate --mesh over two replicas on the card, with and without each
    # replica's point images written after a spin kernel on its stream
    # (after the host's last wait on that stream, the colors' copy): the
    # replicas' streams do not wait for the default stream, so the trees
    # agree only if each readback is queued on its replica's stream. A run
    # with other latents between the two leaves other values in the blocks
    # the delayed run's outputs reuse, so a readback that came too early
    # would differ.
    render = FinalGenerator.render_point_images

    def delayed(self, *args):
        out = render(self, *args)
        torch.cuda._sleep(EVAL_DELAY_CYCLES)
        return out.clone()

    trees = {}
    for name, seed, fn in (("eval_mesh2", 0, render), ("eval_mesh2_seed1", 1, render),
                           ("eval_mesh2_delayed", 0, delayed)):
        with mock.patch.object(final_mod, "mesh_devices", lambda device: [dev, dev]), \
                mock.patch.object(FinalGenerator, "render_point_images", fn), \
                decode_paths() as paths:
            ops.reset_launch_counts()
            stats = evaluate.main(["--config", str(root / "eval.yaml"), "--checkpoint_stage1",
                                   s1_dir, "--checkpoint_stage2", ck2, "--save_dir",
                                   str(root / name), "--seed", str(seed), "--mesh"])
            counts = ops.launch_counts()
        check(stats["batches"] == 1 and counts == generate_launches(paths, 2, EVAL_LAUNCHES),
              f"evaluate --mesh over two replicas ({name}): launches {counts}, "
              f"8 / 1 / 2 / 1 / 4 / 28 per replica batch of 4 (decodes: {paths})")
        trees[name] = tree_bytes(root / name)
    got, want = trees["eval_mesh2_delayed"], trees["eval_mesh2"]
    other = sum(trees["eval_mesh2_seed1"][k] != want[k] for k in want)
    check(other > 0 and sorted(got) == sorted(want) and all(got[k] == want[k] for k in want),
          f"evaluate --mesh over two replicas with the point images written after a spin kernel "
          f"of {EVAL_DELAY_CYCLES:,} cycles on each replica's stream writes the undelayed tree "
          f"byte for byte ({len(want)} PNGs; "
          f"the run with other latents between them differs in {other})")
    return rep


# phase 13 (multistep): train_step_multi as one CUDA graph of a step
MULTI_K = 3
MULTI_TIMING_KS = (1, 4, 16)
# the Ks whose call is profiled for device time: a trace of 16 replays holds
# up to 160,000 device operations, seconds to read, for a number that K = 4's
# already gives within 1%
MULTI_PROFILED_KS = (1, 4)
# bench_train's depth here: windows of 2 steps, K = 4 (its defaults: 20, 8)
BENCH_TRAIN_ARGS = ("--iters", "2", "--k", "4")
MULTI_LOSS_RTOL = 1e-5  # stage 1's later steps: STEP_LOSS_RTOL
MULTI_PARAM_ATOL = 1e-5
MULTI_SIGN_REL = 1e-5  # first |g| below this share of its tensor's max: a sign step
MULTI_SIGN_LR = 2.05
MULTI_S1_ENVELOPE = 3.0  # lr a step: JAX's own multi-vs-sequential bound
MULTI_STATS_ATOL = 1e-5


def restore_in_place(trainer, arrays: dict) -> None:
    """Put ``arrays`` (``state_arrays()``'s, on the host) back into the
    trainer's own tensors, rebinding none of them (a captured step graph
    stays valid); the step and Adam's host step counts as well."""
    for name, v in trainer.model.state_dict().items():
        v.copy_(arrays[name])
    for opt, prefix, names in ((trainer.g_opt, f"g_opt.{trainer.G_PREFIX}", trainer._g_names),
                               (trainer.d_opt, f"d_opt.{trainer.D_PREFIX}", trainer._d_names)):
        for name, p in zip(names, opt.param_groups[0]["params"]):
            for key in ("exp_avg", "exp_avg_sq"):
                opt.state[p][key].copy_(arrays[f"{prefix}.{name}.{key}"])
            opt.state[p]["step"] = arrays[f"{prefix}.{name}.step"].clone()
    trainer.step = int(arrays["step"])


def host_arrays(trainer) -> dict:
    return {k: v.detach().cpu().clone() for k, v in trainer.state_arrays().items()}


def multi_inputs(m, stage: int, k: int, seed: int) -> dict:
    """k stacked batches on the card at ``Config()`` shapes, batch
    TRAIN_BATCH: stage 1's frame pairs, stage 2's sequences and step noise,
    uniform and normal draws from ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    b = TRAIN_BATCH
    if stage == 1:
        host = {n: rng.uniform(-1, 1, (k, b, m.image_size, m.image_size, 3)).astype(np.float32)
                for n in ("image", "future_image")}
    else:
        host = {"keypoints": rng.uniform(-1, 1, (k, b, m.n_pts, 2)).astype(np.float32),
                "real_seq": rng.uniform(-1, 1, (k, b, m.n_future_frames, m.n_pts, 2)
                                        ).astype(np.float32),
                "action_code": np.eye(m.n_action, dtype=np.float32)[
                    rng.integers(0, m.n_action, (k, b))],
                "noise": rng.standard_normal((k, b, m.vae_dim)).astype(np.float32)}
    return {n: torch.from_numpy(v).cuda() for n, v in host.items()}


def multi_fns(stage: int, stacked: dict):
    """(the graphed multi over the first ``n`` slices, one eager step on slice i)."""
    def multi(t, n):
        s = {k: v[:n] for k, v in stacked.items()}
        return t.train_step_multi(s) if stage == 1 else t.train_step_multi(s, s["noise"])

    def single(t, i):
        b = {k: v[i] for k, v in stacked.items()}
        return t.train_step(b) if stage == 1 else t.train_step(b, b["noise"])

    return multi, single


def multi_correctness(cfg, stage: int, vgg) -> dict:
    """Phase 13 (a)/(b) for one stage at ``Config()``, f32, batch 16, K = 3:
    the graphed multi against K eager steps from one state, the same bits on
    a second run of the graph, the bookkeeping, a recapture after
    load_state_arrays, and the kernels of one replay."""
    import torch

    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer

    cfg32 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, compute_dtype="float32", batch_size=TRAIN_BATCH))

    def make():
        t = Stage1Trainer(cfg32, vgg, device="cuda") if stage == 1 else Stage2Trainer(
            cfg32, device="cuda")
        t.load_parameters(t.init_parameters(1))
        return t

    stacked = multi_inputs(cfg.model, stage, MULTI_K + 1, 13 + stage)
    multi, single = multi_fns(stage, stacked)
    a, b = make(), make()
    before = host_arrays(a)
    first_grads = {}
    names = {id(p): n for n, p in b.model.named_parameters()}
    apply = b._apply

    def recording(opt, params, grads):
        for p, g in zip(params, grads):
            first_grads.setdefault(names[id(p)], g.detach().clone())
        apply(opt, params, grads)

    b._apply = recording
    t0 = time.perf_counter()
    got = multi(a, MULTI_K)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    want = [single(b, i) for i in range(MULTI_K)]
    lr = a.lr_schedule(0)
    loss_gaps = []
    for i, w in enumerate(want):
        gaps = {k: abs(float(got[k][i]) - float(w[k])) / max(abs(float(w[k])), 1e-12)
                for k in w}
        loss_gaps.append(max(gaps.values()))
    rtol = [MULTI_LOSS_RTOL] + [MULTI_LOSS_RTOL if stage == 2 else STEP_LOSS_RTOL] * (MULTI_K - 1)
    pa, pb = a.model.state_dict(), b.model.state_dict()
    worst, beyond, sign_steps = 0.0, [], 0
    for name, va in pa.items():
        diff = (va - pb[name]).abs()
        if "running_" in name:
            bound = torch.full_like(diff, MULTI_STATS_ATOL)
        elif stage == 1:
            bound = torch.full_like(diff, MULTI_S1_ENVELOPE * lr * MULTI_K)
        else:
            g = first_grads[name].abs()
            sign = g < MULTI_SIGN_REL * float(g.max())
            sign_steps += int((sign & (diff > MULTI_PARAM_ATOL)).sum())
            bound = torch.where(sign, torch.full_like(diff, MULTI_SIGN_LR * lr),
                                torch.full_like(diff, MULTI_PARAM_ATOL))
        worst = max(worst, float(diff.max()))
        if not bool((diff <= bound).all()):
            beyond.append(name)
    param_rule = ("parameters within 1e-5, or 2.05 lr where the first |g| is below 1e-5 of its "
                  "tensor's max" if stage == 2 else
                  f"parameters within {MULTI_S1_ENVELOPE:g} lr a step (JAX's multi envelope), "
                  "BN statistics within 1e-5")
    check(all(g <= r for g, r in zip(loss_gaps, rtol)) and not beyond,
          f"stage {stage}, Config() f32 batch {TRAIN_BATCH}: the graphed train_step_multi "
          f"(K = {MULTI_K}) against {MULTI_K} eager train_steps from one state: losses within "
          f"rtol {rtol} (worst per step {', '.join(f'{g:.3e}' for g in loss_gaps)}); "
          f"{param_rule} (worst |diff| {worst:.3e}"
          + (f", {sign_steps} sign-step elements past 1e-5" if stage == 2 else "")
          + f"); beyond: {beyond[:5]}")
    state = next(iter(a.g_opt.state.values()))["step"]
    check(a.step == MULTI_K and state.device.type == "cpu" and state.dtype == torch.float32
          and int(state) == MULTI_K and not a.g_opt.param_groups[0]["capturable"],
          f"stage {stage}: after the graphed call the step is {a.step} and Adam's step count a "
          f"host f32 tensor of {int(state)}, Adam eager again")

    first, graph = host_arrays(a), next(iter(a._graphs.values()))
    restore_in_place(a, before)
    multi(a, MULTI_K)
    again = host_arrays(a)
    differ = [k for k in first if not torch.equal(first[k], again[k])]
    check(next(iter(a._graphs.values())) is graph and not differ,
          f"stage {stage}: the same graph run again from the same state gives the same bits in "
          f"all {len(first)} arrays")

    c = make()
    c.load_state_arrays(host_arrays(a))
    for t in (a, c):
        single(t, MULTI_K)
    sa, sc = host_arrays(a), host_arrays(c)
    differ = [k for k in sa if not torch.equal(sa[k], sc[k])]
    check(c.step == a.step == MULTI_K + 1 and not differ,
          f"stage {stage}: state_arrays after the graphed call, loaded by a fresh trainer: its "
          f"next eager step gives the original's bits in all {len(sa)} arrays")

    a.load_state_arrays(before)
    dropped = not a._graphs and not graph.valid(a)
    multi(a, MULTI_K)
    again = host_arrays(a)
    differ = [k for k in first if not torch.equal(first[k], again[k])]
    check(dropped and next(iter(a._graphs.values())) is not graph and not differ,
          f"stage {stage}: load_state_arrays drops the graph; the next call captures anew and "
          f"repeats the first call's bits")

    rec = replay_kernels(next(iter(a._graphs.values())).graph)
    want_launches = ({"conv3x3": 0, "pose_head": 1, "gaussian_render": 2,
                      "pose_head_backward": 1, "gaussian_render_backward": 2,
                      "bias_bn_relu": 0, "lstm_cell": 0} if stage == 1
                     else {name: 0 for name in KERNEL_SYMBOLS})
    check(rec["kernels"] > 0 and rec["launches"] == want_launches,
          f"stage {stage}: one replay of the step graph (torch.profiler) runs "
          f"{rec['kernels']} device operations, launches {rec['launches']}")
    return {"loss_gaps": loss_gaps, "worst_param_diff": worst, "sign_step_elements": sign_steps,
            "first_call_s": first_call_s, "replay_ops": rec["kernels"],
            "replay_device_ms": rec["device_ms"], "replay_launches": rec["launches"]}


def multi_timing(cfg, stage: int, vgg) -> dict:
    """Phase 13 (c) for one stage at ``Config()``, bf16, batch 16: the eager
    step and the graphed multi at each K of MULTI_TIMING_KS, ms a step on
    the host clock (synchronised), device ms a step (torch.profiler), the
    capture seconds (the first call less its K steps at the measured rate)
    and each form's peak memory."""
    import torch

    from kpvid_tpu_torch.bench_train import device_profile
    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer

    def device_ms(fn) -> tuple[float, int]:
        return device_profile(fn, torch.device("cuda"))

    t_start = time.perf_counter()
    kmax = max(MULTI_TIMING_KS)
    stacked = multi_inputs(cfg.model, stage, kmax, 23 + stage)
    multi, single = multi_fns(stage, stacked)
    t = Stage1Trainer(cfg, vgg, device="cuda") if stage == 1 else Stage2Trainer(cfg, device="cuda")
    t.load_parameters(t.init_parameters(1))
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        single(t, i)
    torch.cuda.synchronize()
    times = []
    for i in range(10):
        t0 = time.perf_counter()
        single(t, i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    eager_dev, eager_ops = device_ms(lambda: single(t, 0))
    rep = {"eager_ms": float(np.median(times)), "eager_ms_all": times,
           "eager_device_ms": eager_dev, "eager_device_ops": eager_ops,
           "eager_peak_gib": torch.cuda.max_memory_allocated() / 2**30, "graphed": {}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first_s = None
    for k in MULTI_TIMING_KS:
        t0 = time.perf_counter()
        multi(t, k)
        torch.cuda.synchronize()
        first_s = first_s if first_s is not None else (time.perf_counter() - t0, k)
        calls = []
        for _ in range(3):
            t0 = time.perf_counter()
            multi(t, k)
            torch.cuda.synchronize()
            calls.append(1e3 * (time.perf_counter() - t0) / k)
        rep["graphed"][k] = {"ms": float(np.median(calls)), "ms_all": calls}
        if k in MULTI_PROFILED_KS:
            dev, n_ops = device_ms(lambda: multi(t, k))
            rep["graphed"][k].update(device_ms=dev / k, device_ops=n_ops / k)
    k0 = first_s[1]
    rep["capture_s"] = first_s[0] - k0 * rep["graphed"][k0]["ms"] / 1e3
    rep["graphed_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del t
    torch.cuda.empty_cache()
    rep["seconds"] = time.perf_counter() - t_start
    return rep


def multistep_phase(cfg, card: str, root: Path) -> dict:
    """Phase 13: the graphed train_step_multi of both trainers against the
    eager steps, its bookkeeping and kernels, its timings at MULTI_TIMING_KS,
    and the three tools on the card (bench_train, bench_host_pipeline, and
    verify_reference_parity on phase 11's bundles)."""
    import torch

    from kpvid_tpu_torch import bench_host_pipeline, bench_train, evaluate
    from kpvid_tpu_torch import verify_reference_parity
    from kpvid_tpu_torch.losses import synthesize_vgg19_params

    rep = {}
    vgg = synthesize_vgg19_params()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the train CLI: replays repeat their bits
    try:
        for stage in (2, 1):
            rep[f"stage{stage}_check"] = multi_correctness(cfg, stage, vgg)
            torch.cuda.empty_cache()
        for stage in (1, 2):
            r = rep[f"stage{stage}_timing"] = multi_timing(cfg, stage, vgg)
            print(f"multistep stage {stage} on {card}, bf16 batch {TRAIN_BATCH}: eager "
                  f"{r['eager_ms']:.2f} ms a step (median of 10; device {r['eager_device_ms']:.3f}"
                  f" ms over {r['eager_device_ops']} operations), peak {r['eager_peak_gib']:.2f} "
                  f"GiB; graphed: " + "; ".join(
                      f"K = {k}: {g['ms']:.2f} ms a step" + (
                          f" (device {g['device_ms']:.3f} ms, {g['device_ops']:.0f} operations)"
                          if "device_ms" in g else "") for k, g in r["graphed"].items())
                  + f"; capture {r['capture_s']:.2f} s, peak {r['graphed_peak_gib']:.2f} GiB; "
                  f"{r['seconds']:.1f} s for this measurement", flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    t0 = time.perf_counter()
    rep["bench_train"] = bench_train.main(list(BENCH_TRAIN_ARGS))
    rep["bench_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["host_pipeline"] = bench_host_pipeline.main(["--root", str(root / "hostbench"),
                                                     "--batches", "4"])
    rep["host_pipeline_s"] = time.perf_counter() - t0

    # the parity harness on phase 11's two TF1 bundles over phase 6's tree,
    # against the evaluate tree of phase 11's imports (their own checkpoints:
    # phase 11 trained stage 2 on from its import)
    imported = root / "log_import"
    evaluate.main(["--config", str(root / "eval.yaml"), "--checkpoint_stage1",
                   str(imported / "detector_translator" / "ckpt-0"), "--checkpoint_stage2",
                   str(imported / "motion_generator" / f"ckpt-{IMPORT_STEP}"),
                   "--save_dir", str(root / "eval_imported")])
    t0 = time.perf_counter()
    out = io.StringIO()
    with mock.patch("sys.stdout", out):
        rc = verify_reference_parity.main([
            "--config", str(root / "eval.yaml"),
            "--tf-checkpoint-stage1", str(root / "tf1_stage1" / "model.ckpt-200000"),
            "--tf-checkpoint-stage2", str(root / "tf1_stage2" / "model.ckpt-200000"),
            "--work-dir", str(root / "parity"), "--reference-outputs",
            str(root / "eval_imported")])
    rep["parity_s"] = time.perf_counter() - t0
    text = out.getvalue()
    print(text, flush=True)
    got, want = tree_bytes(root / "parity" / "renders"), tree_bytes(root / "eval_imported")
    check(rc == 0 and "PASS: |ours - reference| = 0.000 dB" in text and sorted(got) == sorted(want)
          and all(got[k] == want[k] for k in want) and len(want) > 0,
          f"verify_reference_parity on phase 11's TF1 bundles: its renders are the evaluate "
          f"tree of phase 11's imports byte for byte ({len(want)} PNGs) and PASS at 0.000 dB")
    rep["parity_line"] = next(ln for ln in text.splitlines() if ln.startswith("pred-vs-real"))
    return rep


# ------------------------------------------------------- the training chain
# JAX's record of stage 1's test PSNR (dB) on its synthetic tree at Config()
# widths, batch 16, bf16, 'tf1' upsample (docs/PERF.md:566-571); the seed
# gives JAX's initial weights and draws, but bf16 steps on another chip
# round otherwise and the runs part within a few steps, so the port is held
# to the curve, not the bits
JAX_S1_PSNR = {500: 19.68, 1000: 22.41, 1500: 23.49, 2250: 23.61}
QUALITY_S1_STEPS = 2250
QUALITY_S2_STEPS = 2000
QUALITY_SWEEP = 250
QUALITY_CONFIG = "kpvid_tpu_torch/configs/penn_synth.yaml"
S1_PSNR_BAND = 1.5  # dB either side of JAX's at each of its steps
S1_PSNR_FLOOR = 22.0  # dB at the last step
S2_KL_DROP = 0.1  # stage 2's test KL at the last sweep over its first sweep's
QUALITY_STAGE_TIMEOUT_S = 2400
REPO = Path(__file__).resolve().parent


def quality_config(src: str | Path, root: Path, test_interval: int,
                   vggnet: str | Path | None = None) -> Path:
    """A copy of the YAML ``src`` with ``data_dir`` and ``log_dir`` under
    ``root`` and ``training.test_interval`` set; ``paths.vggnet`` is
    ``vggnet``, by default a file that does not exist (stage 1 then
    synthesizes its VGG19 weights, as JAX's record did)."""
    import yaml

    raw = yaml.safe_load(Path(src).read_text())
    raw.setdefault("paths", {}).update(
        data_dir=str(root / "penn"), log_dir=str(root / "log"),
        vggnet=str(vggnet if vggnet is not None else root / "no_vgg19.npy"))
    raw.setdefault("training", {})["test_interval"] = test_interval
    path = root / "quality.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def quality_chain(conf: Path, root: Path, s1_steps: int, s2_steps: int,
                  device: str | None = None) -> list[tuple[str, list[str]]]:
    """The four CLIs of the training chain, as (stage, argv): stage 1 on the
    ``--synthetic`` tree, the labeler on its checkpoint, stage 2 on those
    labels (not ``--synthetic``, which would write random-walk labels) and
    evaluate. A CLI runs loop steps 0 .. max_steps - 1 and sweeps the test
    split after the update of each loop step that ``test_interval`` divides,
    so a sweep at step N takes ``--max-steps N + 1``."""
    py, log = [sys.executable, "-m"], root / "log"
    dev = ["--device", device] if device else []
    cfg = ["--config", str(conf)]
    return [
        ("stage 1", py + ["kpvid_tpu_torch.train", "--mode", "detector_translator", *cfg,
                          "--synthetic", "--no-images", "--max-steps", str(s1_steps + 1), *dev]),
        ("label", py + ["kpvid_tpu_torch.make_pseudo_labels", *cfg, "--checkpoint",
                        str(log / "detector_translator"), *dev]),
        ("stage 2", py + ["kpvid_tpu_torch.train", "--mode", "motion_generator", *cfg,
                          "--no-images", "--max-steps", str(s2_steps + 1), *dev]),
        ("evaluate", py + ["kpvid_tpu_torch.evaluate", *cfg, "--checkpoint_stage1",
                           str(log / "detector_translator"), "--checkpoint_stage2",
                           str(log / "motion_generator"), "--save_dir", str(root / "eval"),
                           *dev]),
    ]


def run_chain(chain: list, root: Path) -> dict:
    """Run each command from the repo root, its output in ``root/<stage>.log``;
    returns each stage's wall seconds. A command that fails or outlasts
    QUALITY_STAGE_TIMEOUT_S (it is killed) fails the check with its log's
    tail."""
    seconds = {}
    for name, argv in chain:
        log = root / f"{name.replace(' ', '_')}.log"
        t0 = time.perf_counter()
        with open(log, "w") as out:
            try:
                rc = subprocess.run(argv, cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                                    timeout=QUALITY_STAGE_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = "killed at its time limit"
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            raise CheckFailed(f"{name}: {' '.join(argv[2:])} exited {rc} after "
                              f"{seconds[name]:.1f} s:\n{log.read_text()[-4000:]}")
    return seconds


def read_sweeps(path: Path) -> dict[int, dict]:
    """A CLI's test_metrics.jsonl as {step: metrics}."""
    rows = [json.loads(ln) for ln in Path(path).read_text().splitlines() if ln.strip()]
    return {int(r["step"]): r for r in rows}


def png_tree_complete(sample_dir: Path, n_frames: int) -> bool:
    """One evaluate sample: 2 PNGs and 5 directories of ``n_frames`` PNGs."""
    return ((sample_dir / "input_im.png").is_file()
            and (sample_dir / "current_points.png").is_file()
            and all(len(list((sample_dir / sub).glob("*.png"))) == n_frames
                    for sub in ("real_seq", "pred_seq", "mask", "crude", "pred_points")))


def quality_misses(s1_psnr: dict, s2_kl: dict, s1_last: int, tree_ok: bool) -> list[str]:
    """The bounds that the chain's curves miss (PERF.md §2): stage 1's test
    PSNR within S1_PSNR_BAND of JAX's at each step of JAX's record and at
    least S1_PSNR_FLOOR at ``s1_last``; stage 2's test KL at its last sweep
    at most S2_KL_DROP of its first; evaluate's full PNG tree."""
    misses = []
    for step, want in JAX_S1_PSNR.items():
        got = s1_psnr.get(step)
        if got is None or not abs(got - want) <= S1_PSNR_BAND:
            misses.append(f"stage 1 test PSNR at step {step}: {got} dB, JAX's {want} dB "
                          f"(bound: within {S1_PSNR_BAND} dB)")
    if not s1_psnr.get(s1_last, -np.inf) >= S1_PSNR_FLOOR:
        misses.append(f"stage 1 test PSNR at step {s1_last}: {s1_psnr.get(s1_last)} dB "
                      f"(bound: >= {S1_PSNR_FLOOR} dB)")
    if len(s2_kl) < 2:
        misses.append(f"stage 2: {len(s2_kl)} test sweep(s), need the first and the last")
    else:
        first, last = s2_kl[min(s2_kl)], s2_kl[max(s2_kl)]
        if not last <= S2_KL_DROP * first:
            misses.append(f"stage 2 test KL at step {max(s2_kl)}: {last}, first sweep "
                          f"{first} (bound: <= {S2_KL_DROP} x the first)")
    if not tree_ok:
        misses.append("evaluate: the PNG tree is incomplete")
    return misses


def quality_run(src: str | Path, root: Path, s1_steps: int, s2_steps: int, interval: int,
                device: str | None = None, vggnet: str | Path | None = None) -> dict:
    """The training chain on ``src``'s configuration under ``root``: the
    commands, each stage's seconds, stage 1's test PSNR and reconstruction
    and stage 2's test KL and reconstruction at every sweep, and whether
    evaluate wrote its whole tree."""
    from kpvid_tpu_torch.configs import load_config

    conf = quality_config(src, root, interval, vggnet)
    chain = quality_chain(conf, root, s1_steps, s2_steps, device)
    seconds = run_chain(chain, root)
    log = root / "log"
    s1 = read_sweeps(log / "detector_translator" / "test_metrics.jsonl")
    s2 = read_sweeps(log / "motion_generator" / "test_metrics.jsonl")
    samples = sorted(p for p in (root / "eval").iterdir() if p.is_dir())
    n_frames = load_config(conf).model.n_future_frames
    return {"commands": [" ".join(argv[2:]) for _, argv in chain], "seconds": seconds,
            "stage1": {s: {"psnr": r["psnr"], "reconstruction_metric": r["reconstruction_metric"]}
                       for s, r in s1.items()},
            "stage2": {s: {"kl_loss": r["kl_loss"], "recon_loss": r["recon_loss"]}
                       for s, r in s2.items()},
            "eval_samples": len(samples),
            "tree_ok": bool(samples) and all(png_tree_complete(p, n_frames) for p in samples)}


# the learn phase: the --quality run's stage 1 cut to its first sweep after
# step 0. On the H100 that run's test PSNR rose 1.748 dB by step 250 (16.228
# -> 17.976, PERF.md §6); the bound leaves a 0.748 dB margin
LEARN_STEPS = 250
LEARN_MIN_RISE_DB = 1.0


def learn_phase(card: str, root: Path) -> dict:
    """``train.main`` of stage 1 on ``penn_synth.yaml`` at Config() and its
    ``--synthetic`` tree, as ``--quality`` runs it, for LEARN_STEPS steps
    with a test sweep after step 0 and after step LEARN_STEPS: the test PSNR
    rises by at least LEARN_MIN_RISE_DB; 1 / 2 forward and 1 / 2 backward
    #3 / #4 a step and one forward per sweep."""
    from kpvid_tpu_torch import ops
    from kpvid_tpu_torch.data import ImagePairDataset
    from kpvid_tpu_torch.train import main as train_main

    (root / "learn").mkdir()
    conf = quality_config(REPO / QUALITY_CONFIG, root / "learn", LEARN_STEPS)
    ops.reset_launch_counts()
    run = train_main(["--mode", "detector_translator", "--config", str(conf), "--synthetic",
                      "--no-images", "--max-steps", str(LEARN_STEPS + 1)])
    counts = ops.launch_counts()
    steps = LEARN_STEPS + 1
    m = run["trainer"].config.model
    n_test = len(ImagePairDataset(str(root / "learn" / "penn"), "test", image_size=m.image_size))
    batches = -(-n_test // run["trainer"].config.training.batch_size)
    sweep_fwd = {name: 2 * batches * S1_PER_STEP[name] if name in ("pose_head",
                                                                   "gaussian_render") else 0
                 for name in S1_PER_STEP}
    sweep_fwd["bias_bn_relu"] = 2 * batches * S1_INFERENCE_BN
    want = {name: c * steps + sweep_fwd[name] for name, c in S1_PER_STEP.items()}
    check(counts == want, f"learn: {steps} steps launched {counts}: 1 / 2 forward and 1 / 2 "
                          "backward #3 / #4 a step (+ two sweeps' forwards), no #1 / #2")
    sweeps = read_sweeps(root / "learn" / "log" / "detector_translator" / "test_metrics.jsonl")
    first, last = sweeps[0]["psnr"], sweeps[LEARN_STEPS]["psnr"]
    print(f"learn on {card}: test PSNR {first!r} dB at step 0, {last!r} dB at step "
          f"{LEARN_STEPS}; {steps} steps in {run['seconds']:.1f} s", flush=True)
    check(sorted(sweeps) == [0, LEARN_STEPS] and last - first >= LEARN_MIN_RISE_DB,
          f"learn: the test PSNR rose {last - first:.3f} dB in {LEARN_STEPS} stage-1 steps "
          f"(bound: >= {LEARN_MIN_RISE_DB} dB)")
    return {"psnr": {0: first, LEARN_STEPS: last}, "rise_db": last - first,
            "seconds": run["seconds"],
            "launches_per_step": {k: (v - sweep_fwd[k]) / steps for k, v in counts.items()}}


def quality_phase(card: str) -> dict:
    """``--quality``: the chain at ``penn_synth.yaml``'s Config() widths,
    2,250 stage-1 and 2,000 stage-2 steps with test sweeps every 250, held
    to JAX's learning curve."""
    with tempfile.TemporaryDirectory(prefix="kpvid_quality_") as tmp:
        run = quality_run(REPO / QUALITY_CONFIG, Path(tmp), QUALITY_S1_STEPS, QUALITY_S2_STEPS,
                          QUALITY_SWEEP)
    for name, s in run["seconds"].items():
        print(f"quality {name}: {s:.1f} s wall on {card}", flush=True)
    for step, r in sorted(run["stage1"].items()):
        want = f", JAX {JAX_S1_PSNR[step]:.2f}" if step in JAX_S1_PSNR else ""
        print(f"quality stage 1 step {step}: test PSNR {r['psnr']!r} dB{want}, "
              f"reconstruction {r['reconstruction_metric']!r}", flush=True)
    for step, r in sorted(run["stage2"].items()):
        print(f"quality stage 2 step {step}: test KL {r['kl_loss']!r}, reconstruction "
              f"{r['recon_loss']!r}", flush=True)
    print(f"quality evaluate: {run['eval_samples']} samples, tree complete: {run['tree_ok']}",
          flush=True)
    run["misses"] = quality_misses({s: r["psnr"] for s, r in run["stage1"].items()},
                                   {s: r["kl_loss"] for s, r in run["stage2"].items()},
                                   QUALITY_S1_STEPS, run["tree_ok"])
    run["card"] = card
    print(json.dumps(run), flush=True)
    check(not run["misses"], "the training chain meets every bound of PERF.md §2"
          + "".join(f"\n  missed: {m}" for m in run["misses"]))
    return run


KERNEL_META = {
    # the bf16 body the path runs; conv3x3.cu includes it and holds the f32 route
    "conv3x3_affine": ("cuda", "kpvid_tpu_torch/csrc/conv3x3_mma.cuh",
                       "kpvid_tpu/ops/pallas_conv.py:158"),
    "up2_conv3_affine": ("cuda", "kpvid_tpu_torch/csrc/conv3x3_mma.cuh",
                         "kpvid_tpu/ops/pallas_conv.py:434"),
    # no TPU kernel: XLA's split first conv and oct0a's BN + ReLU
    "conv3x3_add_affine": ("cuda", "kpvid_tpu_torch/csrc/conv3x3_mma.cuh",
                           "kpvid_tpu/eval/final.py::_split_first_conv, "
                           "kpvid_tpu/ops/pallas_chain.py:90"),
    "pose_head": ("cuda", "kpvid_tpu_torch/csrc/keypoint.cu",
                  "kpvid_tpu/ops/pallas_kernels.py:92"),
    "gaussian_render": ("cuda", "kpvid_tpu_torch/csrc/keypoint.cu",
                        "kpvid_tpu/ops/pallas_kernels.py:146"),
    # the backwards of #3 and #4: JAX differentiates their jnp forms
    # (kpvid_tpu/ops/coords.py:50-92) by autodiff; the TPU kernels have no VJP
    "pose_head_backward": ("cuda", "kpvid_tpu_torch/csrc/keypoint.cu",
                           "kpvid_tpu/ops/pallas_kernels.py:92"),
    "gaussian_render_backward": ("cuda", "kpvid_tpu_torch/csrc/keypoint.cu",
                                 "kpvid_tpu/ops/pallas_kernels.py:146"),
    # no TPU kernel: XLA fuses a ConvBNReLU's bias add, BN and ReLU
    "bias_bn_relu": ("cuda", "kpvid_tpu_torch/csrc/bias_bn_relu.cu",
                     "none: XLA fuses kpvid_tpu/models/layers.py's ConvBNReLU"),
    # no TPU kernel: XLA fuses the jnp LSTM cell (the f32 dot and the gates)
    "lstm_cell": ("cuda", "kpvid_tpu_torch/csrc/lstm_cell.cu",
                  "none: XLA fuses kpvid_tpu/models/layers.py's StackedLSTM cell"),
}


KAT_PATH = Path(__file__).resolve().parent / "tests" / "data" / "jax_random_kat.json"
# Random123's known-answer vectors of threefry2x32_20 (its kat_vectors file):
# key, counter, output
RANDOM123_KAT = (
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
)
SUM_COLUMNS = 4096


def leaf_sum(arr) -> float:
    """A float64 sum of ``arr`` with a fixed order of additions, so that the
    same values give the same bits on any host: the values in rows of
    ``SUM_COLUMNS`` (zero-padded), the rows added one after another, then
    the column sums added exactly (``math.fsum``)."""
    import math

    a = np.asarray(arr, np.float64).reshape(-1)
    rows = np.concatenate([a, np.zeros((-a.size) % SUM_COLUMNS)]).reshape(-1, SUM_COLUMNS)
    acc = np.zeros(SUM_COLUMNS)
    for row in rows:
        acc += row
    return math.fsum(acc.tolist())


def ulps(got, want) -> np.ndarray:
    """|got - want| in f32 units in the last place (both f32 arrays)."""
    def ordered(x):  # the f32 bit patterns on one monotonic integer line
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(got) - ordered(want))


def digest(arr) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def prng_trees(cfg) -> dict:
    """The full-width objects whose ``init_parameters`` phase 15 holds to
    JAX's: name -> a constructor (all on the CPU: the draws are the host's)."""
    from kpvid_tpu_torch.eval import FinalGenerator
    from kpvid_tpu_torch.losses import synthesize_vgg19_params
    from kpvid_tpu_torch.train import Stage1Trainer, Stage2Trainer

    return {
        "final_generator": lambda: FinalGenerator(cfg, device="cpu"),
        # init_state draws no VGG weight: 16-channel stand-ins keep it short
        "stage1_trainer": lambda: Stage1Trainer(cfg, synthesize_vgg19_params(max_width=16),
                                                device="cpu"),
        "stage2_trainer": lambda: Stage2Trainer(cfg, device="cpu"),
    }


def prng_phase(card: str) -> dict:
    """Phase 15: the JAX streams against the recorded answers, then the
    full-width trees' leaf sums and seconds (see the module docstring)."""
    from kpvid_tpu_torch import evaluate
    from kpvid_tpu_torch.bridge import to_flax_layout
    from kpvid_tpu_torch.configs import Config
    from kpvid_tpu_torch.utils import jax_random as jr

    kat = json.loads(KAT_PATH.read_text())
    t0 = time.perf_counter()
    for key, ctr, want in RANDOM123_KAT:
        y0, y1 = jr.threefry2x32(np.array(key, np.uint32), np.array([ctr[0]], np.uint32),
                                 np.array([ctr[1]], np.uint32))
        check((int(y0[0]), int(y1[0])) == want,
              f"prng: threefry2x32_20 of key {key[0]:#x},{key[1]:#x} counter "
              f"{ctr[0]:#x},{ctr[1]:#x} is Random123's {want[0]:#x},{want[1]:#x}")
    exact = n_normal = n_equal = worst = 0
    wrong = []
    for entry in kat["seeds"]:
        seed, key = entry["seed"], jr.PRNGKey(entry["seed"])
        got = {"key": key.tolist(),
               "split": {n: jr.split(key, int(n)).tolist() for n in entry["split"]},
               "fold_in": {d: jr.fold_in(key, int(d)).tolist() for d in entry["fold_in"]}}
        for name, value in got.items():
            exact += 1
            if value != entry[name]:
                wrong.append(f"seed {seed} {name}")
        for draw in entry["draws"]:
            shape = tuple(draw["shape"])
            for name, arr in (("bits", jr.bits(key, shape)), ("uniform", jr.uniform(key, shape)),
                              ("uniform_affine", jr.uniform(key, shape, np.float32, -3.0, 2.5))):
                exact += 1
                if digest(arr) != draw[name]:
                    wrong.append(f"seed {seed} {name} {shape}")
            d = ulps(jr.normal(key, shape), np.array(draw["normal"], np.float32).reshape(shape))
            n_normal, n_equal = n_normal + d.size, n_equal + int((d == 0).sum())
            worst = max(worst, int(d.max(initial=0)))
    check(not wrong, f"prng: {exact} keys, splits, fold-ins, bits and uniforms of "
                     f"{len(kat['seeds'])} seeds equal JAX's bit for bit; differing: {wrong[:5]}")
    z = kat["evaluate_z"]
    for b, want in enumerate(z["batches"]):
        d = ulps(evaluate.batch_z(z["seed"], b, z["rows"], z["vae_dim"]), np.array(want, np.float32))
        n_normal, n_equal = n_normal + d.size, n_equal + int((d == 0).sum())
        worst = max(worst, int(d.max()))
    check(worst <= 4 and n_equal >= 0.9 * n_normal,
          f"prng: {n_normal} normals (evaluate's latents of batches 0 and 1 at seed {z['seed']} "
          f"among them) within {worst} ulp of JAX's, {n_equal / n_normal:.2%} equal (bounds: 4 "
          f"ulp, 90%)")
    streams_s = time.perf_counter() - t0

    cfg = Config().validate()
    out = {"streams_s": streams_s, "normals": n_normal, "normals_equal": n_equal,
           "normal_max_ulp": worst, "trees": {}}
    for name, build in prng_trees(cfg).items():
        want = kat["trees"][name]
        obj = build()
        t = time.perf_counter()
        params = obj.init_parameters(np.array(want["key"], np.uint32))
        init_s = time.perf_counter() - t
        missing = sorted(set(params) - set(want["sums"]))
        off = []
        worst_rel = None  # the normal(0.02) head's, where the tree has one
        for leaf, val in params.items():
            if leaf in missing:
                continue
            got, ref = leaf_sum(to_flax_layout(val)), want["sums"][leaf]
            if leaf.endswith("to_coord.weight"):  # normal(0.02): the erfinv's last bits
                rel = abs(got - ref) / max(abs(ref), 1e-30)
                worst_rel = max(worst_rel or 0.0, rel)
                if rel > 1e-6:
                    off.append(leaf)
            elif got != ref:
                off.append(leaf)
        n_values = sum(v.numel() for v in params.values())
        check(not missing and not off,
              f"prng: {name}.init_parameters at Config() width ({len(params)} leaves, "
              f"{n_values:,} values) in {init_s:.2f} s on the host, every leaf's sum JAX's "
              + ("(exact)" if worst_rel is None else
                 f"(exact; the normal(0.02) head within {worst_rel:.1e} relative)")
              + f"; not in the file: {missing[:3]}, differing: {off[:5]}")
        out["trees"][name] = {"leaves": len(params), "values": n_values, "init_s": init_s,
                              "normal_max_rel": worst_rel}
    out["card"] = card
    print(f"prng: {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank-worker":
        return dp_rank_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-rank-worker":
        return tp_rank_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kpvid_tpu_torch.configs import Config
    from kpvid_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_line()
    print(card, flush=True)
    t_start = time.perf_counter()
    if sys.argv[1:] == ["--quality"]:
        quality_phase(card)
        print(f"quality: {time.perf_counter() - t_start:.1f} s", flush=True)
        print(gpu_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    def phase(name: str) -> None:
        print(f"== {name}: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    build_s = _build.build_all()
    for src, log in _build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{src}: " + " | ".join(regs), flush=True)
    print(f"kernel build: {build_s:.1f} s", flush=True)
    sass_phase()

    cfg = Config().validate()
    phase("2 kernels")
    records = kernel_phase(cfg)
    per_bucket = bucket_kernel_phase(cfg)
    params = randomized_params(cfg, seed=0)
    phase("3 slice")
    counts = slice_phase(cfg, params)
    f32_path_phase(cfg, params)
    phase("4 throughput")
    fps = throughput_phase(cfg, params, card)
    phase("5 serve")
    serve = serve_phase(cfg, params, card)
    with tempfile.TemporaryDirectory(prefix="kpvid_smoke_") as tmp:
        root = Path(tmp)
        phase("5b artifact")
        artifact = artifact_phase(cfg, params, card, root)
        phase("6 label")
        label = label_phase(cfg, params, card, root)
        phase("7 stage 1")
        stage1 = stage1_phase(cfg, card, root)
        relabel = relabel_phase(cfg, root)
        phase("8 train")
        train = train_phase(cfg, card, root)
        phase("9 evaluate")
        evaluation = evaluate_phase(cfg, card, root)
        phase("10 dp")
        dp = dp_phase(cfg, card, root, {1: stage1["step_ms"], 2: train["step_ms"]})
        # phase 11's TF1 imports run in processes of their own beside the ranks
        imports = start_tf1_imports(cfg, params, root)
        dp = dp_ranks_phase(cfg, card, root, dp)
        phase("11 interop")
        interop = interop_phase(cfg, params, card, root, imports)
        phase("12 tp_mesh")
        tp = tp_mesh_phase(cfg, params, card, root)
        phase("13 multistep")
        multistep = multistep_phase(cfg, card, root)
        phase("14 learn")
        learn = learn_phase(card, root)
        phase("15 prng")
        prng = prng_phase(card)
        phase("end")

    kernels = []
    records.update(stage1.pop("kernels"))
    for name, (route, source, replaces) in KERNEL_META.items():
        r = records[name]
        s1 = stage1["launches_per_step"][name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            # per generate; the backwards, which only stage-1 training runs,
            # per stage-1 train step
            "launches": counts[name] or s1,
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_f32": r["max_abs_err_f32"], "ms": r["ms"],
            "host_loop_ms": r["host_loop_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "launches_per_path": {
                "generate": counts[name],
                "serve_per_batch": serve["pipeline"]["launches_per_batch"][name],
                "artifact_per_batch": artifact["children"]["cpu"]["launches_per_batch"][name],
                "label_per_chunk": label["launches"][name] / label["chunks"],
                "train_stage1_per_step": s1,
                "evaluate_per_batch": evaluation["launches_per_batch"][name],
                "train_per_step": train["launches_per_step"][name],
                "train_stage1_dp_per_step_per_rank": dp["launches_dp_per_step"][name],
                "train_stage1_accum2_per_step": dp["launches_accum_per_step"][name],
                "generate_from_imported": interop["generate_launches"][name],
                "train_stage1_cached_per_step":
                    interop["stage1_cached"]["launches_per_step"][name],
                "train_stage1_tp_per_step_per_rank": tp["launches_tp_per_step"][name],
                "generate_mesh_per_replica_batch": tp["mesh_launches_per_replica"][name],
                # from a trace: the counters count a graph's capture, not its replays
                "train_stage1_graphed_per_replay":
                    multistep["stage1_check"]["replay_launches"][REPLAY_SYMBOL.get(name, name)],
                "train_stage1_learn_per_step": learn["launches_per_step"][name],
            },
        })
        if counts[name]:
            kernels[-1]["max_abs_err_per_bucket"] = {b: e[name] for b, e in per_bucket.items()}
            if name in per_bucket[SERVE_BUCKETS[0]]["device_ms"]:
                kernels[-1]["device_ms_per_bucket"] = {
                    b: e["device_ms"][name] for b, e in per_bucket.items()}
        else:
            kernels[-1].update({k: r[k] for k in ("forward_train_ms", "launch_floor_ms",
                                                  "zero_fill_ms", "ms_after_64mb_write")
                                if k in r})
        if "b32" in r:
            kernels[-1]["batch32"] = r["b32"]
        if name == "pose_head":
            kernels[-1]["label_chunk"] = label["pose_head_chunk"]
        if name == "gaussian_render":
            kernels[-1]["evaluate_point_images_128"] = evaluation["render_128"]
    print(json.dumps({"kernels": kernels, "batch": BATCH, "frames_per_s_b32_bf16": fps,
                      "serve": serve, "artifact": artifact, "label": {k: v for k, v in label.items()
                                                if k != "pose_head_chunk"},
                      "stage1": stage1, "relabel": relabel,
                      "train": train, "evaluate": {k: v for k, v in evaluation.items()
                                                   if k != "render_128"},
                      "dp": {k: v for k, v in dp.items() if not k.startswith("launches_")},
                      "interop": interop,
                      "tp_mesh": {k: v for k, v in tp.items() if not k.startswith("launches")},
                      "multistep": multistep, "learn": learn, "prng": prng, "card": card,
                      "seconds": time.perf_counter() - t_start}))
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
