"""Device idle share of a traced window: 100 * (1 - busy / window), where
busy is the union of the card's kernel and copy intervals inside it. Each
``idle_pct.<kind>`` reads the runs of its driver kind."""


def idle(rec: dict, kind: str):
    if rec.get("kind") != kind or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
