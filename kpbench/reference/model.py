"""The reference's whole computations: generation, one 'fused' training step
of each stage, and Adam. Plain PyTorch over the functions of nets.py; no
import of the port.

``m`` is the ``model`` section of a configuration file (kpbench/configs).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import nets
from .nets import PLAIN
from .spec import VGG19_LAYOUT, VGG_TAPS

BETAS, EPS = (0.5, 0.999), 1e-8


# -------------------------------------------------------------- generation
def generate(P, im, act, z, m: dict, q=PLAIN) -> dict:
    """im [B, H, W, 3] in [-1, 1], act [B, A] one-hot, z [B, vae_dim] ->
    pred_im_seq [B, T, H, W, 3] clipped to [-1, 1], mask [B, T, H, W, 1],
    current_points [B, K, 2], future_points [B, T, K, 2]."""
    b, t, k, hs = im.shape[0], m["n_future_frames"], m["n_pts"], m["heatmap_size"]
    cur = nets.pose_encoder(im, P, "stage1.pose_encoder", False, q)
    fut = nets.motion_decode(z, cur.reshape(b, -1), act, P, "stage2", t, q).reshape(b, t, k, 2)
    emb = nets.conv_encoder(im, P, "stage1.image_encoder.trunk", False, levels=2, q=q)[-1]
    cur_map = nets.render(cur, hs, m["heatmap_inv_std"])
    fut_map = nets.render(fut.reshape(b * t, k, 2), hs, m["heatmap_inv_std"])
    static = torch.cat([emb, cur_map], dim=-1).repeat_interleave(t, dim=0)
    crude, mask = nets.translator(torch.cat([static, fut_map], dim=-1), P, "stage1.translator",
                                  False, q)
    final = torch.clamp(nets.blend(im.repeat_interleave(t, dim=0), crude, mask), -1.0, 1.0)
    hw = tuple(im.shape[1:3])
    return {"pred_im_seq": final.reshape(b, t, *hw, 3), "mask": mask.reshape(b, t, *hw, 1),
            "current_points": cur, "future_points": fut}


def quantize(x, rescale: bool = True):
    """[-1, 1] (or [0, 1]) -> uint8, truncating after * 255: the served bytes."""
    x = 0.5 * (x + 1.0) if rescale else x
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


# ------------------------------------------------------------------ losses
def bce(logits, target: float):
    x = logits
    return torch.mean(torch.clamp(x, min=0.0) - x * target + torch.log1p(torch.exp(-x.abs())))


def vgg_features(vgg, rgb_0_255, q=PLAIN):
    """The five taps of VGG19 (``vgg``: ``{name}.kernel`` HWIO, ``{name}.bias``)
    on images in [0, 255], BGR with the ImageNet mean taken off."""
    mean = torch.tensor((103.939, 116.779, 123.68), device=rgb_0_255.device)
    x = rgb_0_255.flip(-1) - mean
    taps = []
    for name, _, pool in VGG19_LAYOUT:
        x = torch.relu(nets.conv(x, vgg[name + ".kernel"].permute(3, 2, 0, 1),
                                 vgg[name + ".bias"], q=q))
        if name in VGG_TAPS:
            taps.append(x)
            if len(taps) == len(VGG_TAPS):
                break
        if pool:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return taps


def perceptual(vgg, gt, pred, q=PLAIN):
    n = gt.shape[0]
    feats = vgg_features(vgg, torch.cat([gt, pred]), q)
    return torch.stack([torch.mean(torch.abs(f[:n] - f[n:])) for f in feats]).mean()


def to_0_255(x):
    return (x + 1.0) * 127.5


# -------------------------------------------------------------- train steps
def stage1_losses(G, D, vgg, im, fut, m: dict, q=PLAIN):
    """Stage 1's 'fused' step, losses and gradients: the generator's
    (perceptual + adversarial, against D as it is) and the discriminator's
    on (future frame, detached prediction); BN on batch statistics, the pose
    encoder's over both frames at once."""
    b, hs, inv = im.shape[0], m["heatmap_size"], m["heatmap_inv_std"]
    emb = nets.conv_encoder(im, G, "stage1.image_encoder.trunk", True, levels=2, q=q)[-1]
    mu = nets.pose_encoder(torch.cat([im, fut]), G, "stage1.pose_encoder", True, q)
    maps = [nets.render(mu[:b], hs, inv), nets.render(mu[b:], hs, inv)]
    crude, mask = nets.translator(torch.cat([emb] + maps, dim=-1), G, "stage1.translator", True,
                                  q)
    final = nets.blend(im, crude, mask)
    recon = perceptual(vgg, to_0_255(fut), to_0_255(final), q)
    adv = bce(nets.patchgan(final, D, "image_discriminator", q), 1.0)
    loss_g = recon + adv
    logits = nets.patchgan(torch.cat([fut, final.detach()]), D, "image_discriminator", q)
    loss_d = bce(logits[:b], 1.0) + bce(logits[b:], 0.0)
    return {"loss_G": loss_g, "loss_D": loss_d, "reconstruction_metric": recon,
            "G_adv_loss": adv, "pred": final}


def stage2_losses(G, D, batch: dict, noise, m: dict, q=PLAIN):
    """Stage 2's 'fused' step: the VAE-GAN generator's KL + 1000 L1 +
    adversarial loss and the sequence discriminator's on (real, detached
    prediction)."""
    b = batch["keypoints"].shape[0]
    first = batch["keypoints"].reshape(b, -1)
    real = batch["real_seq"].reshape(b, batch["real_seq"].shape[1], -1)
    act = batch["action_code"]
    mu, sd = nets.motion_encode(real, first, act, G, "stage2", m["vae_dim"], q)
    pred = nets.motion_decode(mu + sd * noise, first, act, G, "stage2", m["n_future_frames"], q)
    recon = torch.mean(1000.0 * torch.abs(pred - real))
    var = torch.square(sd)
    kl = torch.mean(0.5 * torch.sum(torch.square(mu) + var - torch.log(1e-8 + var) - 1.0, dim=1))
    adv = bce(nets.seq_discriminator(pred, D, "discriminator", q), 1.0)
    logits = nets.seq_discriminator(torch.cat([real, pred.detach()]), D, "discriminator", q)
    loss_d = bce(logits[:b], 1.0) + bce(logits[b:], 0.0)
    return {"loss_G": kl + recon + adv, "loss_D": loss_d, "recon_loss": recon, "kl_loss": kl,
            "G_adv_loss": adv, "pred": pred}


def lr_at(count: int, lr: dict) -> float:
    """tf.train.exponential_decay(start, step, decay) at the count of updates
    made before this one, in f32."""
    init = torch.tensor(lr["start_val"], dtype=torch.float32)
    if count <= 0:
        return float(init)
    c = torch.tensor(count / lr["step"], dtype=torch.float32)
    return float(init * torch.pow(torch.tensor(lr["decay"], dtype=torch.float32), c))


class Adam:
    """torch.optim.Adam's update, b1 0.5, b2 0.999, eps 1e-8, no decay."""

    def __init__(self, params: dict):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(EPS)
            params[k].addcdiv_(self.m[k], denom, value=-lr / c1)


def train_steps(G: dict, D: dict, losses_fn, inputs: list, lr: dict) -> dict:
    """'fused' steps from (G, D), one for each entry of ``inputs`` (the
    arguments of ``losses_fn`` after G and D): both gradients against the
    networks before the step, then both updates. Returns each step's
    losses, the first step's gradients and prediction (the generator's
    output, ``pred``), and the parameters after."""
    G = {k: v.clone().requires_grad_(True) for k, v in G.items()}
    D = {k: v.clone().requires_grad_(True) for k, v in D.items()}
    gk = [k for k, v in G.items() if v.is_floating_point() and not k.endswith(("running_mean",
                                                                                 "running_var"))]
    dk = list(D)
    opt_g, opt_d = Adam({k: G[k] for k in gk}), Adam({k: D[k] for k in dk})
    losses, first = [], None
    for i, args in enumerate(inputs):
        out = losses_fn(G, D, *args)
        g = torch.autograd.grad(out["loss_G"], [G[k] for k in gk], allow_unused=True,
                                materialize_grads=True)
        d = torch.autograd.grad(out["loss_D"], [D[k] for k in dk])
        if i == 0:
            first = {**dict(zip(gk, (x.detach() for x in g))),
                     **dict(zip(dk, (x.detach() for x in d)))}
            pred = out["pred"].detach()
        opt_g.step({k: G[k] for k in gk}, dict(zip(gk, g)), lr_at(i, lr))
        opt_d.step({k: D[k] for k in dk}, dict(zip(dk, d)), lr_at(i, lr))
        losses.append({k: float(v.detach()) for k, v in out.items() if k != "pred"})
    return {"losses": losses, "first_grads": first, "pred": pred,
            "params": {k: v.detach() for k, v in {**G, **D}.items() if k in first}}
