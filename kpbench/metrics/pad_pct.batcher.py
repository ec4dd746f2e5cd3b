"""Share of the dispatched rows that were padding (a batch zero-padded up
to its bucket) over the window: the differences of
``MicroBatcher.padded_rows_total`` and ``rows_total``."""


def read(rec: dict):
    if not rec.get("batches"):
        return None
    return 100.0 * rec["padded"] / (rec["rows"] + rec["padded"])
