"""The serving cells' load generator, a child process of the standard
library alone:

    python kpbench/drivers/_load_client.py job.json

It sends the job's ``warmup`` requests, waits for their answers, prints one
line ``{"window_start": <time.time()>}`` and then sends each ``window``
request at its due time (``window_start`` + its offset), open loop: a
dispatcher thread hands each request at its time to a pool of ``threads``
connections, so a slow answer delays no later send. Each request is
``POST /v1/generate`` with its photo (base64 JPEG), action, seed and
format. Its latency runs from its due time to the last byte of its answer.
Answers still out ``wait_after`` seconds after the window's last due time
count as failed. It writes ``results.json`` (per window request: due,
sent, done, HTTP status, bytes) and the answers of the ``sample`` requests
(``answer_<i>``) into ``out``.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def post(port: int, body: bytes, timeout: float) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main() -> None:
    job = json.loads(Path(sys.argv[1]).read_text())
    out = Path(job["out"])
    out.mkdir(parents=True, exist_ok=True)
    photos, port, fmt = job["photos"], job["port"], job["format"]
    sample = set(job["sample"])

    def body(req) -> bytes:
        _, photo, action, seed = req
        return json.dumps({"image": photos[photo], "action": action, "seed": seed,
                           "format": fmt}).encode()

    pool = ThreadPoolExecutor(max_workers=job["threads"])
    t0 = time.time()
    warm = []
    for r in job["warmup"]:
        time.sleep(max(0.0, t0 + r[0] - time.time()))
        warm.append(pool.submit(post, port, body(r), 120.0))
    for f in warm:
        f.result()
    start = time.time() + 0.2
    print(json.dumps({"window_start": start}), flush=True)

    results = [None] * len(job["window"])
    lock = threading.Lock()
    last_due = start + (job["window"][-1][0] if job["window"] else 0.0)
    deadline = last_due + job["wait_after"]

    def send(i, req, due):
        sent = time.time()
        try:
            status, data = post(port, body(req), max(1.0, deadline - sent))
        except Exception:  # noqa: BLE001 - a refused or lost request counts as failed
            status, data = 0, b""
        done = time.time()
        if status == 200 and i in sample:
            (out / f"answer_{i}").write_bytes(data)
        with lock:
            results[i] = {"due": due, "sent": sent, "done": done, "status": status,
                          "bytes": len(data)}

    futures = []
    for i, req in enumerate(job["window"]):
        due = start + req[0]
        time.sleep(max(0.0, due - time.time()))
        futures.append(pool.submit(send, i, req, due))
    for f in futures:
        f.result()
    pool.shutdown(wait=True)
    (out / "results.json").write_text(json.dumps(results))


if __name__ == "__main__":
    main()
