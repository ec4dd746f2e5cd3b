"""Model FLOPs of a whole computation, counted by running the plain
reference on the ``meta`` device under ``torch.utils.flop_counter``: the
convolutions and products (forward and, for a training step, the backward
that ``torch.autograd.grad`` asks for), no elementwise work."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from kpbench.reference import model as ref
from kpbench.reference import spec


def _meta(shapes: dict) -> dict:
    return {k: torch.empty(v, device="meta") for k, v in shapes.items()}


def generate_flops(m: dict, batch: int) -> float:
    """One generate call of ``batch`` images. The translator's first conv is
    counted as the exact split computes it: its static channels (the
    embedding and the current map) once a sample, its future-map channels
    once a frame."""
    s, t, k = m["image_size"], m["n_future_frames"], m["n_pts"]
    P = _meta(spec.generation(m))
    im = torch.empty(batch, s, s, 3, device="meta")
    act = torch.empty(batch, m["n_action"], device="meta")
    z = torch.empty(batch, m["vae_dim"], device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.generate(P, im, act, z, m)
    hs, f = m["heatmap_size"], m["translator_filters"]
    static = 4 * m["encoder_filters"] + k
    saved = 2.0 * batch * (t - 1) * hs * hs * f * 9 * static
    return float(fc.get_total_flops()) - saved


def stage1_step_flops(m: dict, batch: int) -> float:
    """One 'fused' stage-1 step: the generator forward (the pose encoder on
    the 2B pair), VGG19 on the 2B pair, both discriminator passes, and the
    gradients the step takes."""
    s = m["image_size"]
    G, D = _meta(spec.stage1_generator(m)), _meta(spec.image_discriminator(m))
    vgg = _meta(spec.vgg19())
    im, fut = (torch.empty(batch, s, s, 3, device="meta") for _ in range(2))
    return _step_flops(G, D, lambda G, D: ref.stage1_losses(G, D, vgg, im, fut, m))


def stage2_step_flops(m: dict, batch: int) -> float:
    """One 'fused' stage-2 step: encoder and decoder LSTMs, the sequence
    discriminator on the fake and on the real/fake pair, and the gradients."""
    k, t = m["n_pts"], m["n_future_frames"]
    G, D = _meta(spec.motion_generator(m, encoder=True)), _meta(spec.seq_discriminator(m))
    b = {"keypoints": torch.empty(batch, k, 2, device="meta"),
         "real_seq": torch.empty(batch, t, k, 2, device="meta"),
         "action_code": torch.empty(batch, m["n_action"], device="meta")}
    noise = torch.empty(batch, m["vae_dim"], device="meta")
    return _step_flops(G, D, lambda G, D: ref.stage2_losses(G, D, b, noise, m))


def _step_flops(G: dict, D: dict, losses) -> float:
    G = {k: v.requires_grad_(True) for k, v in G.items()}
    D = {k: v.requires_grad_(True) for k, v in D.items()}
    with FlopCounterMode(display=False) as fc:
        out = losses(G, D)
        torch.autograd.grad(out["loss_G"], list(G.values()), allow_unused=True)
        torch.autograd.grad(out["loss_D"], list(D.values()))
    return float(fc.get_total_flops())
