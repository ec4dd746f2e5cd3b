"""Stage-2 trainer: a class-conditional VAE-GAN over keypoint sequences.

Counterpart of kpvid_tpu/train/stage2.py::Stage2Trainer. The generator is
``MotionGenerator(encoder=True)`` and the discriminator ``SeqDiscriminator``,
both with f32 parameters and compute in ``training.compute_dtype``; no BN.
The generator loss is KL + 1000 x L1 reconstruction + adversarial BCE, the
discriminator loss BCE(real, 1) + BCE(fake, 0) (losses/).

The VAE noise is an argument of every step, drawn by the caller (train/cli.py
draws it on the host from a generator seeded by (seed, step)), so the card
and the CPU, and a resumed run, see the same noise. The GAN step modes:

- ``train_step`` ('fused'): one batch, one generator forward; the generator's
  update and the discriminator's both see the opponent as it was before the
  step; the discriminator trains on the generator forward's detached output;
- ``train_step_dg`` ('fused_dg'): the discriminator first, on a no-grad
  generator forward (``noise_d``), then the generator against the updated
  discriminator (``noise_g``);
- ``train_step_two_batch`` ('two_batch'): as 'fused_dg', each update on a
  batch of its own;
- ``train_step_accum`` ('fused' with ``training.grad_accum`` K > 1): the
  noise is taken for the whole batch and split with it into K micros; each
  generator loss against the discriminator before the update, each
  discriminator loss against its micro's fake; the summed gradients divided
  by K, one update each. With no BN this is the full-batch 'fused' step up
  to float reassociation.

Gradients are taken with ``torch.autograd.grad`` over one network's
parameters, so the generator's backward through the discriminator leaves
nothing in the discriminator's gradients. With a ``mesh``
(parallel/dp_step.py) the gradients and metrics are averaged over its
'data' axis, and each step's noise is the global batch's: every rank is
handed the same [global batch, vae_dim] draw and takes rows
``[d * b, (d + 1) * b)`` for its ``b`` local rows at data coordinate ``d``,
so the pairing of noise and rows is the single-process step's. A 'model'
axis shards the wide arrays (train/state.py); at ``Config()`` the six LSTM
layers' kernels and biases, whose gate GEMMs then run column-parallel.
``train_step_multi`` is JAX's scan of K 'fused' steps over stacked batches
and K noise draws; on the card one step captured as a CUDA graph and
replayed K times (train/state.py).
"""

from __future__ import annotations

import torch

from ..configs import Config
from ..device import resolve_device, to_device
from ..losses import discriminator_loss, generator_adv_loss, kl_raw_sigma, seq_recon_loss
from ..models import MotionGenerator, SeqDiscriminator
from ..ops.batching import pair_fns, resolve_pair_mode
from .state import GANTrainer


class Stage2Trainer(GANTrainer):
    """Parameters keyed ``stage2.*`` (FinalGenerator's name for the motion
    generator) and ``discriminator.*``."""

    G_PREFIX = "stage2"
    D_PREFIX = "discriminator"

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 mesh=None):
        self.config = config
        self.device = resolve_device(device)
        m = config.model
        self.dtype = (
            torch.bfloat16 if config.training.compute_dtype == "bfloat16" else torch.float32
        )
        self.n_pts = m.n_pts
        self.vae_dim = m.vae_dim
        self.n_future = m.n_future_frames
        self._setup(MotionGenerator(m.n_pts, m.n_action, m.n_future_frames, m.cell_info,
                                    m.vae_dim, self.dtype, encoder=True),
                    SeqDiscriminator(2 * m.n_pts, m.cell_info, self.dtype),
                    config, self.device, mesh)
        self.pair_mode = resolve_pair_mode(config.training.pair_batching)
        self._pair, self._unpair = pair_fns(self.pair_mode)

    # --------------------------------------------------------------- helpers
    def _flatten_batch(self, batch: dict):
        """keypoints [B, K, 2] -> first_pt [B, 2K]; real_seq [B, T, K, 2] ->
        [B, T, 2K], the last axis (x0, y0, x1, y1, ...)."""
        kp = to_device(batch["keypoints"], self.device, torch.float32)
        real = to_device(batch["real_seq"], self.device, torch.float32)
        act = to_device(batch["action_code"], self.device, torch.float32)
        b = kp.shape[0]
        return kp.reshape(b, -1), real.reshape(b, real.shape[1], -1), act

    def _noise(self, noise) -> torch.Tensor:
        return to_device(noise, self.device, torch.float32)

    def _local_noise(self, noise, rows: int) -> torch.Tensor:
        """This rank's rows of a train step's noise, drawn for the global
        batch (``rows`` local rows at each of ``data_size`` data coordinates)."""
        if noise.shape[0] != rows * self.data_size:
            raise ValueError(f"step noise of {noise.shape[0]} rows for {rows} local rows on "
                             f"{self.data_size} data coordinate(s): draw it for the global batch")
        return self._noise(noise[self.data_index * rows:(self.data_index + 1) * rows])

    def g_grads(self, first_pt, real_seq, act, noise):
        """Generator loss and its gradients against the discriminator as it
        is; returns (grads, detached pred_seq, metrics)."""
        pred_seq, mu, stddev = self.generator(real_seq, first_pt, act, self._noise(noise))
        fake_logit = self.discriminator(pred_seq)
        recon = seq_recon_loss(pred_seq, real_seq)
        kl = kl_raw_sigma(mu, stddev)
        adv = generator_adv_loss(fake_logit)
        loss = kl + recon + adv
        grads = torch.autograd.grad(loss, self._g_params)
        metrics = {"loss_G": loss.detach(), "recon_loss": recon.detach(),
                   "kl_loss": kl.detach(), "G_adv_loss": adv.detach()}
        return grads, pred_seq.detach(), metrics

    def _d_logits(self, real_seq, pred_seq):
        """(real_logit, fake_logit) from one discriminator forward over the pair."""
        return self._unpair(self.discriminator(self._pair(real_seq, pred_seq.to(real_seq.dtype))))

    def d_grads(self, real_seq, pred_seq):
        """Discriminator loss on (real, detached fake) and its gradients."""
        loss, d_real, d_fake = discriminator_loss(*self._d_logits(real_seq, pred_seq.detach()))
        grads = torch.autograd.grad(loss, self._d_params)
        return grads, {"loss_D": loss.detach(), "D_real": d_real.detach(),
                       "D_fake": d_fake.detach()}

    # ----------------------------------------------------------- train steps
    def train_step(self, batch: dict, noise) -> dict:
        first_pt, real_seq, act = self._flatten_batch(batch)
        noise = self._local_noise(noise, first_pt.shape[0])
        g_grads, pred_seq, g_metrics = self.g_grads(first_pt, real_seq, act, noise)
        d_grads, d_metrics = self.d_grads(real_seq, pred_seq)
        self._apply(self.g_opt, self._g_params, g_grads)
        self._apply(self.d_opt, self._d_params, d_grads)
        return self._finish(d_metrics, g_metrics)

    def train_step_multi(self, batches: dict, noises) -> dict:
        """K 'fused' steps: every array of ``batches`` is [K, B, ...] and
        ``noises`` [K, global batch, vae_dim] (the K draws the CLI would
        make); the metrics come back stacked [K] (JAX's ``train_step_multi``)."""
        stacked = {k: batches[k] for k in ("keypoints", "real_seq", "action_code")}
        return self._multi(dict(stacked, noise=noises))

    def _one_step(self, inputs: dict) -> dict:
        return self.train_step(inputs, inputs["noise"])

    def train_step_accum(self, batch: dict, noise) -> dict:
        first_pt, real_seq, act = self._flatten_batch(batch)
        noise = self._local_noise(noise, first_pt.shape[0])
        return self._accumulate([((f, r, a, n), r) for f, r, a, n
                                 in self._micros(first_pt, real_seq, act, noise)])

    def _d_then_g(self, batch_d, batch_g, noise_d, noise_g) -> dict:
        first_d, real_d, act_d = self._flatten_batch(batch_d)
        with torch.no_grad():
            pred_d, _, _ = self.generator(real_d, first_d, act_d,
                                          self._local_noise(noise_d, first_d.shape[0]))
        d_grads, d_metrics = self.d_grads(real_d, pred_d)
        self._apply(self.d_opt, self._d_params, d_grads)
        first_g, real_g, act_g = self._flatten_batch(batch_g)
        g_grads, _, g_metrics = self.g_grads(first_g, real_g, act_g,
                                             self._local_noise(noise_g, first_g.shape[0]))
        self._apply(self.g_opt, self._g_params, g_grads)
        return self._finish(d_metrics, g_metrics)

    def train_step_dg(self, batch: dict, noise_d, noise_g) -> dict:
        return self._d_then_g(batch, batch, noise_d, noise_g)

    def train_step_two_batch(self, batch_d: dict, batch_g: dict, noise_d, noise_g) -> dict:
        return self._d_then_g(batch_d, batch_g, noise_d, noise_g)

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def eval_step(self, batch: dict, noise) -> dict:
        first_pt, real_seq, act = self._flatten_batch(batch)
        pred_seq, mu, stddev = self.generator(real_seq, first_pt, act, self._noise(noise))
        real_logit, fake_logit = self._d_logits(real_seq, pred_seq)
        loss_d, d_real, d_fake = discriminator_loss(real_logit, fake_logit)
        recon = seq_recon_loss(pred_seq, real_seq)
        kl = kl_raw_sigma(mu, stddev)
        adv = generator_adv_loss(fake_logit)
        return {"loss_D": loss_d, "D_real": d_real, "D_fake": d_fake,
                "loss_G": kl + recon + adv, "recon_loss": recon, "kl_loss": kl,
                "G_adv_loss": adv}

    @torch.no_grad()
    def forward(self, batch: dict, noise):
        """The training forward without gradients -> (pred_seq, mu, stddev)."""
        first_pt, real_seq, act = self._flatten_batch(batch)
        return self.generator(real_seq, first_pt, act, self._noise(noise))

    @torch.no_grad()
    def sample(self, first_pt, act, z) -> torch.Tensor:
        """Decode T future keypoint frames [B, T, 2K] from explicit latents z."""
        return self.generator.decode(self._noise(z), to_device(first_pt, self.device, torch.float32),
                                     to_device(act, self.device, torch.float32))
