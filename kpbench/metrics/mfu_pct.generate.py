"""The whole generate call's share of the card's bf16 peak: the model FLOPs
of one call (kpbench/counts/model.py) over the untraced window's wall time
a call, against 989 TFLOP/s."""

from kpbench.counts import PEAK_FLOPS


def read(rec: dict):
    if "flops_per_call" not in rec:
        return None
    return 100.0 * rec["flops_per_call"] / rec["wall_per_call_s"] / PEAK_FLOPS["bfloat16"]
