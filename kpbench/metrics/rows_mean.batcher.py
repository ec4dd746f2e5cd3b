"""Mean real rows a dispatched batch of the micro-batcher carried over the
window: the differences of ``MicroBatcher.rows_total`` and
``batches_total`` between the window's start and its last answer."""


def read(rec: dict):
    if not rec.get("batches"):
        return None
    return rec["rows"] / rec["batches"]
