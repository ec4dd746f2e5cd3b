"""The traffic: the open-loop schedule repeats from a seed and sends the same
amount of work from every seed; the photos and the request decoding the
reference works out again are the daemon's."""

from __future__ import annotations

import base64
import io
import json

import numpy as np
from PIL import Image

from conftest import BENCH
from kpbench.traffic.open_loop import schedule
from kpbench.traffic.preprocess import preprocess_jpeg, request_z

TRAFFIC = json.loads((BENCH / "workloads" / "penn-final.serve-open.json").read_text())["traffic"]


def test_schedule_repeats_from_a_seed():
    a, b = (schedule(2**31 + 11, TRAFFIC, 10.0) for _ in range(2))
    assert a == b
    c = schedule(2**31 + 12, TRAFFIC, 10.0)
    assert len(c["window"]) == len(a["window"]) == round(TRAFFIC["rate"] * 10.0)
    assert [r[0] for r in c["window"]] != [r[0] for r in a["window"]]
    offsets = [r[0] for r in a["window"]]
    assert offsets == sorted(offsets) and 0.0 <= offsets[0] and offsets[-1] < 10.0
    assert all(0 <= r[2] < TRAFFIC["n_action"] for r in a["window"])


def test_photos_and_decoding_are_the_daemons():
    from kpvid_tpu_torch.data import augment
    from kpvid_tpu_torch.eval.server import preprocess_image
    from kpvid_tpu_torch.eval.server import request_z as port_request_z

    sched = schedule(5, dict(TRAFFIC, image_pool=3), 1.0)
    for photo in sched["photos"]:
        data = base64.b64decode(photo)
        im = Image.open(io.BytesIO(data))
        assert im.size == tuple(TRAFFIC["image_wh"]) and im.format == "JPEG"
        want = preprocess_jpeg(data, 128)
        for ops in (augment.FrameOps(False), augment.resolve_frame_ops("auto")):
            got = preprocess_image(Image.open(io.BytesIO(data)), 128, ops)
            np.testing.assert_array_equal(got, want)
    for seed in (0, 7, 2**31 - 2):
        np.testing.assert_array_equal(request_z(seed, 64), port_request_z(seed, 64))
