"""The whole stage-2 step's share of the card's bf16 peak: the model FLOPs of
one step (kpbench/counts/model.py: the forward, and the backward the step
asks for) over the run's window's wall time a step, against 989 TFLOP/s."""

from kpbench.counts import PEAK_FLOPS


def read(rec: dict):
    if rec.get("kind") != "train" or rec.get("stage") != "stage2":
        return None
    return 100.0 * rec["flops_per_step"] / rec["wall_per_step_s"] / PEAK_FLOPS["bfloat16"]
