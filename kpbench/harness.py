"""What every cell shares: finding a cell's files by name, the seeded weights,
the import check, the trace's reduction and the result line.

A cell is ``kpbench/workloads/<cell>.json`` (its configuration's name, its
driver ``kind`` and its traffic), a configuration ``kpbench/configs/<name>.json``,
a driver ``kpbench/drivers/<kind>.py`` and, for each per-layer metric that
``BENCHMARK.json`` lists for the cell, a reader ``kpbench/metrics/<metric>.py``.
Nothing here names a cell: adding one is adding files.

A cell that ``BENCHMARK.json`` does not list yet runs the same way: its
workload file's ``benchmark`` section holds what the listing would say (its
``chips``, and its ``end_to_end`` and ``per_layer`` metrics, as
``BENCHMARK.json`` writes them). These are the cells PERF.md keeps for later.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kpvid_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX package's,
    compared whole (``kpvid_tpu_torch`` is not ``kpvid_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Cell:
    """One run of one cell: its files, its arguments and its clock."""

    name: str
    seed: int
    seconds: float
    trace: bool
    t0: float  # time.perf_counter() at process start
    bench: dict
    workload: dict
    config: dict
    device: str = "cuda"
    work: Path = None  # the run's scratch directory, inside the checkout
    notes: dict = field(default_factory=dict)

    @classmethod
    def load(cls, name: str, seed: int, seconds: float, trace: bool, t0: float,
             root: Path = BENCH, device: str = "cuda") -> "Cell":
        bench = load_json(root.parent / "BENCHMARK.json")
        workload = load_json(root / "workloads" / f"{name}.json")
        config = load_json(root / "configs" / f"{workload['config']}.json")
        work = root / ".work" / name
        return cls(name, seed, seconds, trace, t0, bench, workload, config, device, work)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def listed(self) -> bool:
        return any(w["name"] == self.name for w in self.bench["workloads"])

    @property
    def chips(self) -> int:
        if self.listed:
            return next(w["chips"] for w in self.bench["workloads"] if w["name"] == self.name)
        return self.workload["benchmark"]["chips"]

    def metrics(self, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that this cell reports:
        BENCHMARK.json's for a listed cell; for another, those of
        BENCHMARK.json's that name no cells and its workload file's own."""
        shared = [m for m in self.bench[section] if "workloads" not in m]
        if not self.listed:
            return shared + self.workload["benchmark"][section]
        return shared + [m for m in self.bench[section] if self.name in m.get("workloads", ())]


# ------------------------------------------------------------------ inputs
def make_params(shapes: dict, seed: int, salt: int, device) -> dict:
    """Weights for ``shapes`` (name -> shape) from ``seed``, made on ``device``
    in two draws (one normal, one uniform) with a ``torch.Generator``:
    convolutions He-normal, products Xavier-uniform, biases N(0, 0.05), BN
    scale 1 + N(0, 0.1), shift and mean N(0, 0.1), variance U(0.5, 1.5)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 64 + salt)
    normal, uniform = [], []  # (name, shape, scale, offset) / (name, shape, lo, hi)
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        n = math.prod(shape)
        if name.endswith("running_var"):
            uniform.append((name, shape, 0.5, 1.5))
        elif name.endswith(("bn.weight",)):
            normal.append((name, shape, 0.1, 1.0))
        elif name.endswith(("bn.bias", "running_mean")):
            normal.append((name, shape, 0.1, 0.0))
        elif len(shape) == 4:  # OIHW or HWIO (VGG's): fan-in is all but the output dim
            fan_in = n // (shape[0] if name.endswith("weight") else shape[-1])
            normal.append((name, shape, math.sqrt(2.0 / fan_in), 0.0))
        elif len(shape) == 2:
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            uniform.append((name, shape, -a, a))
        else:
            normal.append((name, shape, 0.05, 0.0))
    out = {}
    for draw, items in ((torch.randn, normal), (torch.rand, uniform)):
        total = sum(math.prod(s) for _, s, _, _ in items)
        flat = draw(total, generator=gen, device=device, dtype=torch.float32)
        i = 0
        for name, shape, a, b in items:
            n = math.prod(shape)
            x = flat[i:i + n].view(shape)
            out[name] = (x * a + b) if draw is torch.randn else (a + (b - a) * x)
            i += n
    return out


# ----------------------------------------------------------------- traces
def trace_records(prof) -> dict:
    """The raw records of a finished ``torch.profiler.profile`` reduced to
    what the readers take: ``device`` intervals (start ns, end ns, name,
    the id of the host op that launched it) and ``host`` ops (start, end,
    name, thread, input shapes, input dtypes, id). The profiler links a
    kernel or copy to the innermost host op open when it was queued, the
    link ``torch.profiler``'s own ``key_averages`` uses."""
    from torch.profiler import DeviceType

    device, host, ranges = [], [], set()
    for e in prof.profiler.kineto_results.events():
        name, t0, t1 = e.name(), e.start_ns(), e.end_ns()
        if getattr(e, "is_user_annotation", lambda: False)():
            ranges.add(name)
        if e.device_type() == DeviceType.CUDA:
            device.append((t0, t1, name, e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            host.append((t0, t1, name, e.start_thread_id(), [list(s) for s in e.shapes()],
                         list(e.dtypes()), e.correlation_id()))
    # a user range shows on the device's timeline too: it is no work there
    device = [d for d in device if d[2] not in ranges and not d[2].startswith("kpbench.")]
    return {"device": device, "host": host}


def launched_under(rec: dict, op_name: str) -> tuple[list, float]:
    """(the host ops named ``op_name``, the seconds of device time of every
    interval that one of them launched)."""
    ops = [o for o in rec["host"] if o[2] == op_name]
    ids = {o[6] for o in ops}
    return ops, sum(t1 - t0 for t0, t1, _, link in rec["device"] if link in ids) / 1e9


def busy_and_gaps(device: list, lo: int, hi: int) -> tuple[float, list]:
    """(seconds in which some device interval ran inside [lo, hi] ns, the
    idle gaps as (start, end) ns)."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b, *_ in device if b > lo and a < hi)
    busy, gaps, cur = 0, [], lo
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < hi:
        gaps.append((cur, hi))
    return busy / 1e9, gaps


def breakdown(rec: dict, lo: int, hi: int) -> dict:
    """The ten device operations that took most time, and the ten largest
    idle-gap totals by the innermost host op running at each gap's middle
    (gaps of 10 us or more)."""
    import bisect

    ops: dict = {}
    for t0, t1, name, _ in rec["device"]:
        if t1 > lo and t0 < hi:
            ops[name] = ops.get(name, 0.0) + (min(t1, hi) - max(t0, lo)) / 1e9
    _, gaps = busy_and_gaps(rec["device"], lo, hi)
    host = sorted(rec["host"], key=lambda o: (o[0], -o[1]))
    starts = [o[0] for o in host]
    idle: dict = {}
    for a, b in gaps:
        if b - a < 10_000:
            continue
        mid, best = (a + b) // 2, None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= mid:
                best = host[j]
                break
        key = best[2] if best else "no host op traced"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


# ------------------------------------------------------------------ checks
def gap(a, b) -> float:
    """Largest absolute difference of two arrays, in f64."""
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def emit(cell: Cell, *, e2e: dict, layer: dict, checks: dict, attempted: int, failed: int,
         device: dict, breakdown: dict | None = None, stream=sys.stdout) -> dict:
    """Print the checks as the last lines of stderr and the result line as the
    last line of stdout; return the result. ``checks``: name -> (value,
    limit); a check passes at value <= limit."""
    units = {m["name"]: m["unit"] for m in cell.metrics("end_to_end") + cell.metrics("per_layer")}
    names = [m["name"] for m in cell.metrics("per_layer" if cell.trace else "end_to_end")]
    values = layer if cell.trace else e2e
    metrics = {n: {"value": values[n], "unit": units[n]} for n in names
               if values.get(n) is not None}
    ok = all(v <= lim for v, lim in checks.values())
    correct = bool(ok and attempted > 0 and failed == 0 and checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device}
    if cell.trace and breakdown is not None:
        result["breakdown"] = breakdown
    if cell.notes.get("served") or cell.notes.get("readings"):
        result["notes"] = {k: cell.notes[k] for k in ("served", "readings") if k in cell.notes}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(_finite(result)), file=stream, flush=True)
    return result


def _finite(x):
    """JSON without Infinity or NaN: a gap that no answer gave reads 1e308."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    return x


def device_block(cell: Cell, peak: int, records: dict) -> dict:
    """The result line's ``device``: the card's name, one card, the peak;
    in a traced run ``busy_s`` and ``window_s`` too. (A CPU run, the
    benchmark's own tests, says so.)"""
    trace = ({"busy_s": records["busy_s"], "window_s": records["window_s"]}
             if cell.trace else {})
    if cell.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, **trace}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak), **trace}


def now() -> float:
    return time.perf_counter()


def read_layers(cell: Cell, out: dict) -> dict:
    """The driver's output with ``layer``: in a traced run, each per-layer
    metric of the cell read by ``kpbench/metrics/<name>.py`` from the run's
    records (a reader that finds nothing returns None, and the metric is
    left out)."""
    records = out.pop("records", None) or {}
    layer = {}
    if cell.trace:
        for m in cell.metrics("per_layer"):
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 "kpbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(records)
            if value is not None:
                layer[m["name"]] = float(value)
    return dict(out, layer=layer)


def port_config_file(cell: Cell, path: Path, **sections) -> Path:
    """The configuration's ``model``, ``training`` and ``data`` sections (and
    ``sections``, e.g. ``paths``) as the port's YAML file (JSON is YAML)."""
    raw = {k: cell.config[k] for k in ("model", "training", "data") if k in cell.config}
    for k, v in sections.items():
        raw[k] = {**raw.get(k, {}), **v}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(raw, indent=1))
    return path


def fresh_dir(path: Path) -> Path:
    """``path`` emptied (a run's scratch directory, at a fixed place in the
    checkout)."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def chrome_records(path: Path) -> dict:
    """:func:`trace_records`' form from a Chrome trace that
    ``torch.profiler``'s ``export_chrome_trace`` wrote (times in us there,
    ns here; the link is each event's ``External id``)."""
    device, host = [], []
    for e in load_json(path)["traceEvents"]:
        if e.get("ph") != "X":
            continue
        t0 = int(round(float(e["ts"]) * 1000))
        t1 = t0 + int(round(float(e.get("dur", 0)) * 1000))
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in _DEVICE_CATS:
            device.append((t0, t1, e["name"], args.get("External id")))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((t0, t1, e["name"], e.get("tid"), args.get("Input Dims", []),
                         args.get("Input type", []), args.get("External id")))
    return {"device": device, "host": host}
