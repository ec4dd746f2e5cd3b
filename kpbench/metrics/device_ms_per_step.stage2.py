"""Device milliseconds of one stage-2 step: the time in which some kernel or
copy ran on the card in the CLI's own trace of loop steps 10-14 (its
``--profile-dir``), over the 5 steps."""


def read(rec: dict):
    if rec.get("kind") != "train" or rec.get("stage") != "stage2":
        return None
    return 1e3 * rec["busy_s"] / rec["steps"]
