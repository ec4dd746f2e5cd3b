"""Stage-1 trainer: the keypoint detector and translator, with the frozen
VGG19 perceptual loss and the PatchGAN.

Counterpart of kpvid_tpu/train/stage1.py::Stage1Trainer. The generator is
``Stage1Generator`` and the discriminator ``ImageDiscriminator``, both with
f32 parameters and compute in ``training.compute_dtype``. The generator
loss is the perceptual loss of the prediction against the future frame, both
rescaled to [0, 255], plus the adversarial BCE; the discriminator's is
BCE(real, 1) + BCE(fake, 0) on the future frame and the detached prediction,
as one 2B discriminator batch. The step modes:

- ``train_step`` ('fused'): one batch, one generator forward; the
  generator's update and the discriminator's both see the opponent as it
  was before the step;
- ``train_step_dg`` ('fused_dg'): the discriminator first, on a no-grad
  train-mode generator forward, then the generator against the updated
  discriminator;
- ``train_step_two_batch`` ('two_batch'): as 'fused_dg', each update on a
  batch of its own.

BN runs on batch statistics in every training forward; the running
statistics move only in the generator's gradient pass (JAX keeps the
mutated ``batch_stats`` of that pass alone). ``eval_step`` and
``visualize`` take moving-average BN or the batch's statistics as
``training.bn_eval_mode`` and ``summary_bn_mode`` say, and keep nothing.
- ``train_step_accum`` ('fused' with ``training.grad_accum`` K > 1): K
  micros of B/K rows, each generator loss against the discriminator before
  the update and each discriminator loss against its micro's fake; the
  summed gradients divided by K, one update each. Each micro normalizes
  with its own batch statistics and the running statistics take the EMA K
  times a step (the usual accumulation BN, as in JAX).

Gradients are taken with ``torch.autograd.grad`` over one network's
parameters. On the card the soft-argmax and the two Gaussian renders of the
forward run their kernels, and their backwards run theirs. With a ``mesh``
(parallel/dp_step.py) the gradients and metrics are averaged over its
'data' axis, and every training forward of the generator (not
``eval_step`` or ``visualize``) runs sync-BN: its batch statistics are the
mean over the 'data' ranks', as JAX's ``bn_axis`` (not over the 'model'
ranks, which hold the same rows). A 'model' axis shards the wide arrays
(train/state.py); at ``Config()`` the PatchGAN's ``conv4`` and ``conv5``.
``train_step_multi`` is JAX's scan of K 'fused' steps over stacked batches;
on the card one step captured as a CUDA graph (the six keypoint kernels
and the BN statistics' updates in it) and replayed K times (train/state.py).

The generator's arrays are keyed ``stage1.*``, as ``FinalGenerator`` names
them, so a trainer checkpoint is also a stage-1 parameter file; the
discriminator's are keyed ``image_discriminator.*``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs import Config
from ..device import resolve_device, to_device
from ..losses import discriminator_loss, generator_adv_loss, perceptual_loss, prepare_vgg19
from ..models import (
    ImageDiscriminator,
    Stage1Generator,
    syncing_batch_stats,
    updating_batch_stats,
)
from ..ops.batching import pair_fns, resolve_pair_mode
from .state import GANTrainer


def to_0_255(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255], the scale the perceptual loss is taken at."""
    return (x + 1.0) * 127.5


class Stage1Trainer(GANTrainer):
    G_PREFIX = "stage1"  # FinalGenerator's name for the stage-1 generator
    D_PREFIX = "image_discriminator"

    def __init__(self, config: Config, vgg_params: dict, device: str | torch.device = "cuda",
                 mesh=None):
        self.config = config
        self.device = resolve_device(device)
        m, t = config.model, config.training
        self.dtype = torch.bfloat16 if t.compute_dtype == "bfloat16" else torch.float32
        self.pair_mode = resolve_pair_mode(t.pair_batching)
        self._pair, self._unpair = pair_fns(self.pair_mode)
        self._setup(Stage1Generator(m.n_pts, m.image_size, m.encoder_filters,
                                    m.translator_filters, m.pose_decoder_filters, self.dtype,
                                    m.heatmap_size, m.heatmap_inv_std, self.pair_mode),
                    ImageDiscriminator(m.discriminator_filters, self.dtype), config, self.device,
                    mesh)
        self.vgg = prepare_vgg19(vgg_params, self.device)
        self.bn_eval_train = t.bn_eval_mode == "train"
        self.summary_train = t.summary_bn_mode == "train"
        self.remat_vgg = t.remat_vgg

    # --------------------------------------------------------------- helpers
    def _pair_of(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        return (to_device(batch["image"], self.device, torch.float32),
                to_device(batch["future_image"], self.device, torch.float32))

    def _recon(self, gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        def loss(a, b):
            return perceptual_loss(self.vgg, to_0_255(a), to_0_255(b), self.dtype,
                                   self.pair_mode)

        if self.remat_vgg:
            # the loss draws no random numbers; restoring the RNG state in the
            # recompute would also stop a CUDA graph's capture of the step
            return checkpoint(loss, gt, pred, use_reentrant=False, preserve_rng_state=False)
        return loss(gt, pred)

    def g_grads(self, im: torch.Tensor, future_im: torch.Tensor):
        """The generator's loss and its gradients against the discriminator
        as it is, the BN running statistics moved by this pass; returns
        (grads, detached prediction, metrics)."""
        with updating_batch_stats(self.generator), self._sync_bn():
            out = self.generator(im, future_im, train=True)
        fake = out["final"]
        recon = self._recon(future_im, fake)
        adv = generator_adv_loss(self.discriminator(fake))
        loss = recon + adv
        # the image encoder's last octave feeds nothing: zero gradients, as in JAX
        grads = torch.autograd.grad(loss, self._g_params, allow_unused=True,
                                    materialize_grads=True)
        metrics = {"loss_G": loss.detach(), "reconstruction_metric": recon.detach(),
                   "G_adv_loss": adv.detach()}
        return grads, fake.detach(), metrics

    def _d_logits(self, real: torch.Tensor, fake: torch.Tensor):
        """(real_logit, fake_logit) from one discriminator forward over the pair."""
        return self._unpair(self.discriminator(self._pair(real, fake)))

    def _sync_bn(self):
        """Sync-BN in the data-parallel step's training forwards."""
        return syncing_batch_stats(self.generator, self.data_parallel,
                                   self.mesh.data_group if self.mesh is not None else None)

    def d_grads(self, real: torch.Tensor, fake: torch.Tensor):
        """The discriminator's loss on (real, detached fake) and its gradients."""
        loss, d_real, d_fake = discriminator_loss(*self._d_logits(real, fake.detach()))
        grads = torch.autograd.grad(loss, self._d_params)
        return grads, {"loss_D": loss.detach(), "D_real": d_real.detach(),
                       "D_fake": d_fake.detach()}

    # ----------------------------------------------------------- train steps
    def train_step(self, batch: dict) -> dict:
        im, future_im = self._pair_of(batch)
        g_grads, fake, g_metrics = self.g_grads(im, future_im)
        d_grads, d_metrics = self.d_grads(future_im, fake)
        self._apply(self.g_opt, self._g_params, g_grads)
        self._apply(self.d_opt, self._d_params, d_grads)
        return self._finish(d_metrics, g_metrics)

    def train_step_multi(self, batches: dict) -> dict:
        """K 'fused' steps: ``image`` and ``future_image`` of ``batches`` are
        [K, B, H, W, 3]; the metrics come back stacked [K] (JAX's
        ``train_step_multi``)."""
        return self._multi({k: batches[k] for k in ("image", "future_image")})

    def _one_step(self, inputs: dict) -> dict:
        return self.train_step(inputs)

    def train_step_accum(self, batch: dict) -> dict:
        im, future_im = self._pair_of(batch)
        return self._accumulate([((i, f), f) for i, f in self._micros(im, future_im)])

    def _d_then_g(self, batch_d: dict, batch_g: dict) -> dict:
        im_d, future_d = self._pair_of(batch_d)
        with torch.no_grad(), self._sync_bn():
            fake_d = self.generator(im_d, future_d, train=True)["final"]
        d_grads, d_metrics = self.d_grads(future_d, fake_d)
        self._apply(self.d_opt, self._d_params, d_grads)
        g_grads, _, g_metrics = self.g_grads(*self._pair_of(batch_g))
        self._apply(self.g_opt, self._g_params, g_grads)
        return self._finish(d_metrics, g_metrics)

    def train_step_dg(self, batch: dict) -> dict:
        return self._d_then_g(batch, batch)

    def train_step_two_batch(self, batch_d: dict, batch_g: dict) -> dict:
        return self._d_then_g(batch_d, batch_g)

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Losses and PSNR on a test batch, BN as ``bn_eval_mode`` says."""
        im, future_im = self._pair_of(batch)
        fake = self.generator(im, future_im, train=self.bn_eval_train)["final"]
        real_logit, fake_logit = self._d_logits(future_im, fake)
        loss_d, d_real, d_fake = discriminator_loss(real_logit, fake_logit)
        recon = perceptual_loss(self.vgg, to_0_255(future_im), to_0_255(fake), self.dtype,
                                self.pair_mode)
        adv = generator_adv_loss(fake_logit)
        mse = torch.mean(torch.square(torch.clamp(fake, -1, 1) - future_im))
        psnr = 10.0 * torch.log10(4.0 / torch.clamp(mse, min=1e-10))
        return {"loss_D": loss_d, "D_real": d_real, "D_fake": d_fake, "loss_G": recon + adv,
                "reconstruction_metric": recon, "G_adv_loss": adv, "psnr": psnr}

    @torch.no_grad()
    def visualize(self, batch: dict) -> dict:
        """The generator's outputs for the summary images, BN as
        ``summary_bn_mode`` says."""
        return self.generator(*self._pair_of(batch), train=self.summary_train)
