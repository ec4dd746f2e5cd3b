"""The HTTP daemon under open-loop load: ``eval/server.py::make_server``
around an ``InferenceEngine`` in this process, on a free localhost port,
with ``serve.py``'s defaults (buckets 1-32, 5 ms linger, 256 queued,
pipeline on), and the load generator in a child process
(drivers/_load_client.py).

The workload file gives ``traffic`` (kpbench/traffic/open_loop.py; its
``rate`` is a number found by the recorded sweep, kpbench/tools/
sweep_serve.py), ``client_threads``, ``wait_after``, ``sample_requests``
(answers kept for the check, drawn from the seed), ``check_rows``,
``trace_seconds`` and ``checks`` (name -> limit). Set-up is this process's
start to the window's start: the engine, every bucket warmed, the client's
warm-up requests answered. ``request_p95_ms`` is the 95th percentile over
every request due in the window of its due time to its answer's last byte,
a failed request counting as slower than every success. The batcher's
cumulative counters are read at the window's start and after its last
answer. A traced run traces ``trace_seconds`` of the window from its
start.

The check decodes the kept answers' npz bodies and compares them with the
plain reference run on the same photo (decoded and cropped again by
kpbench/traffic/preprocess.py), action and request seed, quantized to
uint8 as the daemon serves them.
"""

from __future__ import annotations

import gc
import io
import json
import subprocess
import sys
import threading
import time

import numpy as np

from kpbench import harness


def program(cell: harness.Cell, params: dict):
    """The system under test: the live engine on the one device."""
    import torch

    from kpvid_tpu_torch.configs import load_config
    from kpvid_tpu_torch.eval.server import InferenceEngine

    config = load_config(harness.port_config_file(cell, cell.work / "config.yaml"))
    return InferenceEngine(config, params, device=torch.device(cell.device))


def counters(batcher) -> dict:
    with batcher._stats_lock:
        return {k: getattr(batcher, k) for k in ("batches_total", "rows_total",
                                                 "padded_rows_total")}


def run(cell: harness.Cell) -> dict:
    import torch

    from kpbench.reference import spec
    from kpbench.traffic.open_loop import schedule
    from kpvid_tpu_torch.eval.server import make_server

    wl, m = cell.workload, cell.model
    work = harness.fresh_dir(cell.work)
    t0_wall = time.time() - (time.perf_counter() - cell.t0)
    dev = torch.device(cell.device)
    params = harness.make_params(spec.generation(m), cell.seed, 1, dev)
    engine = cell.notes.get("program", program)(cell, params)
    server, batcher = make_server(engine, port=0, warmup=True)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()

    sched = schedule(cell.seed, wl["traffic"], cell.seconds, cell.notes.get("rate"))
    pick = np.random.default_rng(cell.seed + 1)
    n = len(sched["window"])
    sample = sorted(int(i) for i in pick.choice(n, min(wl["sample_requests"], n), replace=False))
    job = {"port": server.server_address[1], "photos": sched["photos"],
           "warmup": sched["warmup"], "window": sched["window"], "sample": sample,
           "format": wl["traffic"]["format"], "threads": wl["client_threads"],
           "wait_after": wl["wait_after"], "out": str(work / "client")}
    (work / "job.json").write_text(json.dumps(job))
    client = subprocess.Popen([sys.executable, str(harness.BENCH / "drivers" / "_load_client.py"),
                               str(work / "job.json")], stdout=subprocess.PIPE, text=True,
                              cwd=harness.CHECKOUT)
    records = {}
    try:
        line = client.stdout.readline()
        start = json.loads(line)["window_start"]
        setup_s = start - t0_wall
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        time.sleep(max(0.0, start - time.time()))
        c0 = counters(batcher)
        if cell.trace:
            records = trace_window(cell)
        client.wait(timeout=cell.seconds + wl["wait_after"] + 120)
        c1 = counters(batcher)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
        server.shutdown()
        batcher.stop()
        server.server_close()
    results = json.loads((work / "client" / "results.json").read_text())
    # a failed request is slower than any success could be (the client waits
    # at most wait_after past the window for an answer)
    worst = (cell.seconds + wl["wait_after"] + 1.0) * 1e3
    lat = sorted((r["done"] - r["due"]) * 1e3 if r["status"] == 200 else worst
                 for r in results)
    failed = sum(r["status"] != 200 for r in results)
    p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
    e2e = {"request_p95_ms": p95, "setup_s": setup_s}
    d = {k: c1[k] - c0[k] for k in c0}
    records.update(rows=d["rows_total"], batches=d["batches_total"],
                   padded=d["padded_rows_total"])
    cell.notes["served"] = {"requests": len(results), "failed": failed,
                            "late_send_ms_max": max(((r["sent"] - r["due"]) * 1e3
                                                     for r in results), default=0.0),
                            "p50_ms": lat[len(lat) // 2] if lat else None}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, server, batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cell, params, sched, sample, work / "client")
    return {"e2e": e2e, "records": records, "checks": checks, "attempted": len(results),
            "failed": failed, "device": harness.device_block(cell, peak, records),
            "breakdown": records.get("breakdown")}


def trace_window(cell) -> dict:
    """A ``torch.profiler`` trace of ``trace_seconds`` of the window (the
    card's kernels and copies, the host ops), inside one ``kpbench.window``
    range of this thread, which only waits."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function("kpbench.window"):
            time.sleep(cell.workload["trace_seconds"])
    rec = harness.trace_records(prof)
    lo, hi = next((o[0], o[1]) for o in rec["host"] if o[2] == "kpbench.window")
    busy, _ = harness.busy_and_gaps(rec["device"], lo, hi)
    rec.update(kind="serve", window=(lo, hi), busy_s=busy, window_s=(hi - lo) / 1e9,
               breakdown=harness.breakdown(rec, lo, hi))
    return rec


def compare(cell, params: dict, sched: dict, sample: list, answers, q=None) -> dict:
    """The kept answers against the reference: the widest gap of a served
    frame or mask byte (uint8 steps), the largest mean gap of a request's
    frames, and the widest gap of its keypoints. ``answers`` is the
    directory the client kept them in (one that never came reads as an
    infinite gap), or None for the control's readings: the reference then
    answers in the program's place in the precision ``q``."""
    import base64

    import torch

    from kpbench.reference import model as ref
    from kpbench.reference.nets import plain_backends
    from kpbench.traffic.preprocess import preprocess_jpeg, request_z

    plain_backends()
    m = cell.model
    dev = next(iter(params.values())).device
    gaps = {"frames_u8": 0.0, "frames_u8_mean": 0.0, "masks_u8": 0.0, "points": 0.0}
    with torch.no_grad():
        for i in sample:
            _, photo, action, seed = sched["window"][i]
            im = preprocess_jpeg(base64.b64decode(sched["photos"][photo]), m["image_size"])
            act = np.zeros((1, m["n_action"]), np.float32)
            act[0, action] = 1.0
            z = request_z(seed, m["vae_dim"])[None]
            args = [torch.from_numpy(a).to(dev) for a in (im[None], act, z)]
            want = ref.generate(params, *args, m)
            if answers is None:  # the control answers this request
                out = ref.generate(params, *args, m, q=q)
                got = {"pred_im_seq": ref.quantize(out["pred_im_seq"][0]).cpu().numpy(),
                       "mask": ref.quantize(out["mask"][0], rescale=False).cpu().numpy(),
                       "current_points": out["current_points"][0].cpu().numpy(),
                       "future_points": out["future_points"][0].cpu().numpy()}
            elif (answers / f"answer_{i}").exists():
                got = np.load(io.BytesIO((answers / f"answer_{i}").read_bytes()))
            else:
                gaps = {k: float("inf") for k in gaps}
                continue
            frames = ref.quantize(want["pred_im_seq"][0]).cpu().numpy().astype(np.int32)
            masks = ref.quantize(want["mask"][0], rescale=False).cpu().numpy().astype(np.int32)
            df = np.abs(got["pred_im_seq"].astype(np.int32) - frames)
            gaps["frames_u8"] = max(gaps["frames_u8"], float(df.max()))
            gaps["frames_u8_mean"] = max(gaps["frames_u8_mean"], float(df.mean()))
            gaps["masks_u8"] = max(gaps["masks_u8"], float(
                np.abs(got["mask"].astype(np.int32) - masks).max()))
            gaps["points"] = max(gaps["points"],
                                 harness.gap(got["current_points"], want["current_points"][0].cpu()),
                                 harness.gap(got["future_points"], want["future_points"][0].cpu()))
    cell.notes["readings"] = gaps
    limits = cell.workload["checks"]
    return {k: (gaps[k], limits[k]) for k in limits}


def readings(cell: harness.Cell, seeds: list, variants: list) -> list:
    """The check's numbers for each seed: 'program' through a whole run;
    'control' as the reference in float8 answers the same sampled requests
    (a request's answer depends on its own row alone, whatever batch the
    daemon puts it in), without the daemon, which at the cell's load the
    reference could not keep up with."""
    import torch

    from kpbench.reference import spec
    from kpbench.reference.nets import fp8
    from kpbench.traffic.open_loop import schedule

    lines = []
    for seed in seeds:
        cell.seed = seed
        for variant in variants:
            if variant == "program":
                out = run(cell)
                lines.append({"seed": seed, "variant": variant, "checks": cell.notes["readings"],
                              "e2e": out["e2e"], "attempted": out["attempted"],
                              "failed": out["failed"]})
                continue
            params = harness.make_params(spec.generation(cell.model), seed, 1,
                                         torch.device(cell.device))
            sched = schedule(seed, cell.workload["traffic"], cell.seconds, cell.notes.get("rate"))
            n = len(sched["window"])
            pick = np.random.default_rng(seed + 1)
            sample = sorted(int(i) for i in pick.choice(n, min(cell.workload["sample_requests"], n),
                                                        replace=False))
            compare(cell, params, sched, sample, None, q=fp8)
            lines.append({"seed": seed, "variant": variant, "checks": cell.notes["readings"]})
    return lines
