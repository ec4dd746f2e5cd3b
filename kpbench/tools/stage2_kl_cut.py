"""Where stage 2's worst-leaf first-gradient gap comes from (not run by the
benchmark's own runs):

    python kpbench/tools/stage2_kl_cut.py --seeds 51 52 ... [--device D]
        [--workload penn-train.stage2-b16] [--out F]

runs the CLI's first steps for every seed in one child, as the readings do
(drivers/train_cli.py), then holds each against cuts of the f32 reference
on the same captured batch and noise: the reference with every product's
operands in bf16, with only the encoder head's in bf16, and both again with
the gradient of the KL's ``log(1e-8 + sd^2)`` cut. One JSON line a seed:
each worst-leaf and median-leaf gap of first-gradient norms, measured as
the check measures them, the ``sd`` values near the ReLU's kink, the share
of the encoder's gradient that the log term gives, and the share of
elements whose L1 sign lies within 0.003 of its kink. PERF.md §7 gives the
readings.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))


def bf16(x):
    import torch

    return x.to(torch.bfloat16).to(torch.float32)


def losses(m: dict, q, q_head, cut_log: bool, keep: dict | None = None):
    """reference/model.py's stage-2 losses, with the encoder head's products
    through ``q_head`` and, given ``cut_log``, no gradient through the KL's
    log term."""
    import torch

    from kpbench.reference import model as ref
    from kpbench.reference import nets

    def f(G, D, b):
        n, vd = b["keypoints"].shape[0], m["vae_dim"]
        first = b["keypoints"].reshape(n, -1)
        real = b["real_seq"].reshape(n, b["real_seq"].shape[1], -1)
        act = b["action_code"]
        outs = nets.lstm(real, G, "stage2.enc_lstm", q=q)
        logit = nets.dense(torch.cat([outs[:, -1], first, act], -1), G, "stage2.enc_head",
                           "relu", q=q_head)
        mu, sd = logit[:, :vd], logit[:, vd:]
        pred = nets.motion_decode(mu + sd * b["noise"], first, act, G, "stage2",
                                  m["n_future_frames"], q)
        recon = torch.mean(1000.0 * torch.abs(pred - real))
        var = torch.square(sd)
        log_var = torch.log(1e-8 + (var.detach() if cut_log else var))
        kl = torch.mean(0.5 * torch.sum(torch.square(mu) + var - log_var - 1.0, dim=1))
        adv = ref.bce(nets.seq_discriminator(pred, D, "discriminator", q), 1.0)
        logits = nets.seq_discriminator(torch.cat([real, pred.detach()]), D, "discriminator", q)
        loss_d = ref.bce(logits[:n], 1.0) + ref.bce(logits[n:], 0.0)
        if keep is not None:
            keep.update(sd=sd.detach(), diff=(pred - real).detach())
        return {"loss_G": kl + recon + adv, "loss_D": loss_d, "pred": pred}

    return f


def gaps(got: dict, want: dict) -> dict:
    """Worst and median leaf of |norm - reference norm| over the larger of
    the reference norm and the median leaf's, leaves under a thousandth of
    the median left out (as drivers/train_cli.py::numbers)."""
    med = float(np.median(list(want.values())))
    d = {k: abs(got[k] - want[k]) / max(want[k], med) for k in want if want[k] >= 1e-3 * med}
    worst = max(d, key=d.get)
    return {"worst": d[worst], "leaf": worst, "median": float(np.median(list(d.values())))}


def main(argv=None) -> int:
    p = ArgumentParser()
    p.add_argument("--workload", default="penn-train.stage2-b16")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from kpbench import harness
    from kpbench.reference import model as ref
    from kpbench.reference import spec
    from kpbench.reference.nets import PLAIN, plain_backends

    cell = harness.Cell.load(args.workload, args.seeds[0], 1.0, False, time.perf_counter(),
                             device=args.device)
    driver = harness.load_module(BENCH / "drivers" / "train_cli.py", "kpbench_driver")
    work, cmd = driver.prepare(cell, args.seeds, 10**9, stop_after_capture=True)
    with open(work / "child.out", "w") as out:
        subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=harness.CHECKOUT,
                       check=True)
    plain_backends()
    m, lr = cell.model, cell.config["training"]["lr"]
    for i, seed in enumerate(args.seeds):
        capture = work / "capture" / str(i)
        inputs = np.load(capture / "inputs.npz")
        batch = {k.split(".", 1)[1]: torch.from_numpy(inputs[k]).to(args.device)
                 for k in inputs.files if k.startswith("0.")}
        p0 = harness.make_params(spec.stage2_trainer(m), seed, 2, args.device)
        G = {k: v for k, v in p0.items() if k.startswith("stage2.")}
        D = {k: v for k, v in p0.items() if k not in G}

        def first(q, q_head, cut_log, keep=None):
            grads = ref.train_steps(G, D, losses(m, q, q_head, cut_log, keep), [(batch,)],
                                    lr)["first_grads"]
            return {k: float(v.norm()) for k, v in grads.items()}, grads

        keep = {}
        f32, g = first(PLAIN, PLAIN, False, keep)
        f32_cut, g_cut = first(PLAIN, PLAIN, True)
        program = json.loads((capture / "capture.json").read_text())["grad_norms"]
        sd = keep["sd"]
        line = {
            "seed": seed,
            "program": gaps(program, f32),
            "bf16": gaps(first(bf16, bf16, False)[0], f32),
            "head_bf16": gaps(first(PLAIN, bf16, False)[0], f32),
            "bf16_log_cut": gaps(first(bf16, bf16, True)[0], f32_cut),
            "head_bf16_log_cut": gaps(first(PLAIN, bf16, True)[0], f32_cut),
            "sd_zero": int((sd == 0).sum()), "sd_under_1e-3": int(((sd > 0) & (sd < 1e-3)).sum()),
            "sd_min_positive": float(sd[sd > 0].min()) if (sd > 0).any() else None,
            "log_term_share": {k: float((g[k] - g_cut[k]).norm() / g[k].norm())
                               for k in ("stage2.enc_head.weight", "stage2.enc_lstm.lstm_0_kernel",
                                         "stage2.dec_lstm.lstm_0_kernel")},
            "l1_near_kink": float((keep["diff"].abs() < 3e-3).float().mean()),
        }
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
