"""Stage-2 losses, in f32 whatever the compute dtype.

Copies of kpvid_tpu/losses/vae.py and gan.py:

- ``seq_recon_loss``: mean(1000 * |pred - real|);
- ``kl_raw_sigma``: mean over the batch of
  0.5 * sum_d(mu^2 + sigma^2 - log(1e-8 + sigma^2) - 1), with sigma the
  network's relu output taken as it is (no softplus or exp); the 1e-8 keeps
  it finite at sigma = 0;
- ``bce_logits``: the stable mean BCE-with-logits against a constant target,
  max(x, 0) - x * z + log1p(exp(-|x|)); the discriminator loss is
  BCE(real, 1) + BCE(fake, 0), the generator's adversarial loss BCE(fake, 1).
"""

from __future__ import annotations

import torch


def seq_recon_loss(pred_seq: torch.Tensor, real_seq: torch.Tensor) -> torch.Tensor:
    return torch.mean(1000.0 * torch.abs(pred_seq.float() - real_seq.float()))


def kl_raw_sigma(mu: torch.Tensor, stddev: torch.Tensor) -> torch.Tensor:
    mu = mu.float()
    var = torch.square(stddev.float())
    per_example = 0.5 * torch.sum(torch.square(mu) + var - torch.log(1e-8 + var) - 1.0, dim=1)
    return torch.mean(per_example)


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    x = logits.float()
    return torch.mean(torch.clamp(x, min=0.0) - x * target + torch.log1p(torch.exp(-torch.abs(x))))


def discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor):
    real_loss = bce_logits(real_logits, 1.0)
    fake_loss = bce_logits(fake_logits, 0.0)
    return real_loss + fake_loss, real_loss, fake_loss


def generator_adv_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return bce_logits(fake_logits, 1.0)


__all__ = ["bce_logits", "discriminator_loss", "generator_adv_loss", "kl_raw_sigma",
           "seq_recon_loss"]
