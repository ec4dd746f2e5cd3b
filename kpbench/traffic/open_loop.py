"""Open-loop request traffic for the serving cells, made from ``--seed``.

A workload's ``traffic`` gives ``rate`` (requests/s), ``warmup_requests``,
``image_pool`` (how many distinct photos), ``image_wh`` (their size),
``n_action`` and ``format``. In a window of ``seconds`` the schedule holds
``round(rate * seconds)`` requests at sorted uniform times: a Poisson
process's arrivals given their count, so that every seed sends the same
amount of work at different times. Each request draws its photo from the
pool, its action uniformly and a seed of its own. The photos are JPEGs of
smooth gradients and filled shapes (something a JPEG decoder and a resize
treat as they treat a photo), quality 90.
"""

from __future__ import annotations

import base64
import io

import numpy as np


def photos(rng: np.random.Generator, n: int, wh: tuple[int, int]) -> list[bytes]:
    from PIL import Image, ImageDraw

    w, h = wh
    out = []
    for _ in range(n):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([
            127 + 100 * np.sin(xx / rng.uniform(20, 90) + rng.uniform(0, 6)),
            127 + 100 * np.cos(yy / rng.uniform(20, 90) + rng.uniform(0, 6)),
            127 + 100 * np.sin((xx + yy) / rng.uniform(30, 120)),
        ], axis=-1)
        im = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
        draw = ImageDraw.Draw(im)
        for _ in range(12):
            x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
            x1, y1 = x0 + rng.uniform(10, w / 3), y0 + rng.uniform(10, h / 3)
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            (draw.ellipse if rng.random() < 0.5 else draw.rectangle)([x0, y0, x1, y1], fill=color)
        buf = io.BytesIO()
        im.save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def schedule(seed: int, traffic: dict, seconds: float, rate: float | None = None) -> dict:
    """The run's requests: ``warmup`` (sent before the window, due at even
    gaps) and ``window`` (due at offsets in [0, seconds)), each as
    (offset s, photo index, action, request seed); and the ``photos``
    (base64 JPEG). ``rate`` overrides the traffic's (the rate sweep)."""
    rng = np.random.default_rng(seed)
    rate = traffic["rate"] if rate is None else rate
    pool = [base64.b64encode(b).decode() for b in
            photos(rng, traffic["image_pool"], tuple(traffic["image_wh"]))]
    n = int(round(rate * seconds))
    due = np.sort(rng.uniform(0.0, seconds, n))

    def draw(offsets):
        k = len(offsets)
        return [(float(t), int(p), int(a), int(s)) for t, p, a, s in zip(
            offsets, rng.integers(0, len(pool), k), rng.integers(0, traffic["n_action"], k),
            rng.integers(0, 2**31 - 1, k))]

    nw = traffic["warmup_requests"]
    return {"photos": pool, "rate": rate,
            "warmup": draw(np.arange(nw) / max(rate, 1e-9)), "window": draw(due)}
