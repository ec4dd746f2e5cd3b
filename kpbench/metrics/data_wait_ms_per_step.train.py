"""Milliseconds the CLI's loop waited for its next batch, a step, over the
window: the seconds spent inside its ``kpvid.train.data_wait`` span
(``next(train_iter)`` in train/cli.py) between the window's first and last
marks, timed by the benchmark's child around the CLI's span
(drivers/_train_child.py), over the steps between them. A traced run's
window follows the profiler's steps 10-14, so the wait is read untraced. A
record without it reads None."""


def read(rec: dict):
    wait = rec.get("data_wait")
    return wait[0] / wait[1] * 1e3 if wait else None
