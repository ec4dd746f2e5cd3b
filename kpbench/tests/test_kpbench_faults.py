"""The check fails a broken timed path. Each run here skips run.py's look
for a card and drives the rest of a run on the CPU at smoke widths (f32),
with the cells' own limits, with one of the faults a cell can have planted
underneath: an answer altered where it is produced, half of a batch left
out, a training step that returns its state unchanged, a training step on
half of its batch with the mean taken over the rest. (One card: no
exchange between chips to leave out.)"""

from __future__ import annotations

import pytest

from conftest import drive


def offline_fault(kind):
    def make(driver):
        def program(cell, params):
            generate, sync, launching = driver.program(cell, params)

            def broken(im, act, z):
                if kind == "half":  # the second half of the rows never computed
                    h = im.shape[0] // 2
                    out = generate(im[:h], act[:h], z[:h])
                    return {k: v.repeat(2, *([1] * (v.dim() - 1))) for k, v in out.items()}
                out = dict(generate(im, act, z))
                out["pred_im_seq"] = out["pred_im_seq"].clone()
                out["pred_im_seq"][0, 0, :8, :8] += 0.5  # one frame's corner, as produced
                return out

            return broken, sync, launching

        return program

    return make


def serve_fault(driver):
    def program(cell, params):
        engine = driver.program(cell, params)
        fetch = engine.fetch

        def broken(out):
            out = fetch(out)
            out["mask"][:, 0, :8, :8] ^= 0x40  # every row's first mask, as read back
            return out

        engine.fetch = broken
        return engine

    return program


def test_sound_runs_pass(smoke):
    for cell in ("penn-final.offline-b32", "penn-final.serve-open"):
        assert drive(smoke, cell, seconds=1.0)[0]["correct"]


@pytest.mark.parametrize("kind", ["answer", "half"])
def test_offline_faults_fail(smoke, kind):
    result, _ = drive(smoke, "penn-final.offline-b32", seconds=1.0, program=offline_fault(kind))
    assert not result["correct"]


def test_served_answer_altered_fails(smoke):
    result, _ = drive(smoke, "penn-final.serve-open", seconds=1.0, program=serve_fault)
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["penn-train.stage1-b16", "penn-train.stage2-b16"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half"])
def test_training_faults_fail(smoke, cell, fault):
    def patch(harness):
        real = harness.Cell.load.__func__

        def load(cls, *a, **k):
            c = real(cls, *a, **k)
            c.notes["fault"] = fault
            return c

        harness.Cell.load = classmethod(load)

    result, _ = drive(smoke, cell, seconds=1.0, patch=patch)
    assert result["correct"] == (fault is None)
