"""Device milliseconds of one generate call: the time in which some kernel
or copy ran on the card during the traced calls, over their count."""


def read(rec: dict):
    if "calls" not in rec or "flops_per_call" not in rec:
        return None
    return 1e3 * rec["busy_s"] / rec["calls"]
