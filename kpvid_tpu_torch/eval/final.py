"""Fused end-to-end generation: one image + action class -> T-frame video.

Counterpart of kpvid_tpu/eval/final.py::FinalGenerator:

  pose-encode the input image -> first-frame keypoints (pose_head kernel)
  explicit z -> motion decoder (stacked LSTM) -> T future keypoint frames
  32^2 Gaussian maps (gaussian_render kernel); the translator's first conv
  split so its frame-invariant channels are convolved once per sample;
  the translator decode (conv kernels, ops/chain.py); blend and clip.

The path itself is :class:`GenerateNet`, a module on tensors that
``FinalGenerator.generate`` calls after moving its inputs to the device,
and that the serving artifact traces (eval/export.py).
``render_point_images`` draws evaluate's colorized keypoint images at full
resolution (gaussian_render again, at 128^2).

While a profiler records, ``FinalGenerator.generate`` names its phases
(utils/spans.py): ``kpvid.generate`` around the call, and inside it
``kpvid.generate.inputs`` (the copies to the device), ``.detect``,
``.motion_decode``, ``.first_conv``, ``.translator`` (twice: the heads'
folding, then the decode) and ``.blend``. The serving artifact's graph has
none of them.

The entry point runs on the card by default and raises where there is none;
pass ``device="cpu"`` to run the plain versions on the CPU.

:class:`GeneratorMesh` is one process over several devices, the JAX CLIs'
``--mesh``: a pure 'data' mesh over a device list (``make_mesh(devices=...)``),
the parameters replicated on each device and a batch's rows split evenly
between them. The engine, evaluate and bench always generate through one;
without ``--mesh`` its list is the one device.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Config
from ..device import resolve_device, to_device
from ..models import MotionGenerator, Stage1Generator, init_like_jax
from ..ops.coords import colorize_point_maps
from ..ops.keypoint_kernels import gaussian_render
from ..utils import jax_random
from ..utils.spans import span


class GenerateNet(nn.Module):
    """Generation on tensors: (im [B, H, W, 3] f32 in [-1, 1], action one-hot
    [B, A] f32, z [B, vae_dim] f32) on one device -> the output dict of
    :meth:`FinalGenerator.generate`. Its parameters are those of
    ``stage1`` and ``stage2``, keyed as the checkpoints key them. It is what
    ``torch.export`` traces for the serving artifact (eval/export.py), so
    live serving and the artifact run one code path; the kernels it reaches
    are ``torch.ops.kpvid`` ops and enter the exported graph as such."""

    def __init__(self, stage1: Stage1Generator, stage2: MotionGenerator, n_pts: int,
                 n_future: int, heatmap_size: int, heatmap_inv_std: float, dtype: torch.dtype):
        super().__init__()
        self.stage1 = stage1
        self.stage2 = stage2
        self.n_pts = n_pts
        self.n_future = n_future
        self.heatmap_size = heatmap_size
        self.heatmap_inv_std = heatmap_inv_std
        self.dtype = dtype

    def forward(self, im: torch.Tensor, action_code: torch.Tensor,
                z: torch.Tensor) -> dict[str, torch.Tensor]:
        b = im.shape[0]
        with span("kpvid.generate.detect"):
            current_mu = self.stage1.detect(im)
        first_pt = current_mu.reshape(b, 2 * self.n_pts)
        with span("kpvid.generate.motion_decode"):
            pred_flat = self.stage2.decode(z, first_pt, action_code)  # [B, T, 2K]
        future_mu_seq = pred_flat.reshape(b, self.n_future, self.n_pts, 2)
        with span("kpvid.generate.first_conv"):
            first = self.split_first_conv(im, current_mu, future_mu_seq)
        with span("kpvid.generate.translator"):
            head_k, head_b = self.stage1.translator.fused_heads()
        out = self.stage1.generate(im, first, head_k, head_b)
        return {
            "im": im,
            "pred_im_seq": out["pred_im_seq"],
            "mask": out["mask"],
            "pred_im_crude": out["pred_im_crude"],
            "current_points": current_mu,
            "future_points": future_mu_seq,
            "fut_pt_raw": future_mu_seq,
        }

    def split_first_conv(self, im, current_mu, future_mu_seq) -> torch.Tensor:
        """Pre-activation output of the translator's first conv for all B*T
        frames. Its input channels are [embedding ++ current map ++ future
        map]; the first two are the same for every frame of a sample, so
        they are convolved once per sample (exact by linearity), with the
        bias added once."""
        b, t = future_mu_seq.shape[:2]
        hs, dt, inv_std = self.heatmap_size, self.dtype, self.heatmap_inv_std
        emb = self.stage1.embed(im)
        # JAX renders each map on the grid of its keypoints' dtype: f32 for
        # the detected points, the compute dtype for the decoded ones; both
        # are written once in the compute dtype
        cur_map = gaussian_render(current_mu.float().contiguous(), hs, hs, inv_std, out_dtype=dt)
        fut_map = gaussian_render(
            future_mu_seq.reshape(b * t, self.n_pts, 2).float().contiguous(),
            hs, hs, inv_std, grid_dtype=future_mu_seq.dtype, out_dtype=dt,
        )
        static = torch.cat([emb.to(dt), cur_map], dim=-1)
        conv = self.stage1.translator.oct0a.conv
        weight = conv.weight.to(dt)  # [F, 128 + 2K, 3, 3]
        n_static = static.shape[-1]

        def conv3(x, w):
            y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
            return y.permute(0, 2, 3, 1)

        y_static = conv3(static, weight[:, :n_static]) + conv.bias.to(dt)  # [B, h, w, F]
        y_dyn = conv3(fut_map, weight[:, n_static:])  # [B*T, h, w, F]
        y = y_dyn.reshape(b, t, *y_dyn.shape[1:]) + y_static[:, None]
        return y.reshape(b * t, *y_dyn.shape[1:])


class FinalGenerator:
    def __init__(self, config: Config, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        m = config.model
        self.dtype = (
            torch.bfloat16 if config.training.compute_dtype == "bfloat16" else torch.float32
        )
        self.n_pts = m.n_pts
        self.n_future = m.n_future_frames
        self.stage1 = Stage1Generator(
            m.n_pts, m.image_size, m.encoder_filters, m.translator_filters,
            m.pose_decoder_filters, self.dtype,
        )
        self.stage2 = MotionGenerator(
            m.n_pts, m.n_action, m.n_future_frames, m.cell_info, m.vae_dim, self.dtype
        )
        self.model = GenerateNet(self.stage1, self.stage2, m.n_pts, m.n_future_frames,
                                 m.heatmap_size, m.heatmap_inv_std, self.dtype)
        self.model.to(self.device).eval()

    def init_parameters(self, seed_or_key=0) -> dict[str, torch.Tensor]:
        """The JAX package's ``FinalGenerator.init_variables(key)``, ``key``
        ``PRNGKey(seed)`` for an integer: the stage-1 tree from the first
        key of ``split(key)``, the stage-2 tree from the second, with Flax's
        parameter keys and init laws (``models.init_like_jax``). Drawn on the
        host; keyed like :meth:`load_parameters` takes them."""
        r1, r2 = jax_random.split(jax_random.as_key(seed_or_key))
        return init_like_jax(self.model, {"stage1": r1, "stage2": r2})

    def load_parameters(self, params: dict) -> None:
        """Load a dict from :meth:`init_parameters` or ``bridge.from_jax``."""
        self.model.load_state_dict(
            {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
             for k, v in params.items()},
            strict=True,
        )

    @torch.no_grad()
    def generate(self, im, action_code, z=None, key=None) -> dict:
        """im: [B, H, W, 3] in [-1, 1]; action_code: [B, A] one-hot; z: the
        motion latents [B, vae_dim]. Each sample's output depends only on its
        own (im, action, z) row. Without ``z``, JAX's draw from ``key`` (a
        JAX key or an integer seed for ``PRNGKey``): ``z = normal(key, (B,
        vae_dim))``, drawn on the host.

        Returns im (the input on the device), pred_im_seq [B, T, H, W, 3],
        mask [B, T, H, W, 1], pred_im_crude, current_points [B, K, 2],
        future_points [B, T, K, 2] and fut_pt_raw (the same points, as JAX
        names them too)."""
        if z is None and key is None:
            raise ValueError("generate needs the latents z or a key to draw them from")
        with span("kpvid.generate"):
            with span("kpvid.generate.inputs"):
                if z is None:
                    z = jax_random.normal(jax_random.as_key(key),
                                          (im.shape[0], self.config.model.vae_dim))
                im = to_device(im, self.device, torch.float32)
                act = to_device(action_code, self.device, torch.float32)
                z = to_device(z, self.device, torch.float32)
            return self.model(im, act, z)

    @torch.no_grad()
    def render_point_images(self, mu: torch.Tensor, colors, size: int | None = None) -> torch.Tensor:
        """Colorized keypoint images [N, S, S, 3] of points [N, K, 2] at full
        resolution. As in JAX, the maps are rendered on the grid of the
        points' dtype and tinted in it: f32 for the detected points, the
        compute dtype for the decoded ones. ``colors`` [K, 3] is a host array
        or a tensor on the points' device (no host copy then:
        :meth:`MeshReplica.constant`)."""
        size = size or self.config.model.image_size
        maps = gaussian_render(mu.float().contiguous(), size, size,
                               self.config.model.heatmap_inv_std, grid_dtype=mu.dtype,
                               out_dtype=mu.dtype)
        return colorize_point_maps(maps, colors)


def mesh_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices of one process's mesh, as JAX's ``jax.devices()``: every
    visible card for 'cuda', the CPU once for 'cpu'."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class MeshReplica:
    """One device's :class:`FinalGenerator`, the stream it launches on and
    the stream its readbacks copy on (None on the CPU)."""

    final: FinalGenerator
    stream: torch.cuda.Stream | None
    copy_stream: torch.cuda.Stream | None
    constants: dict = dataclasses.field(default_factory=dict)

    def constant(self, name: str, value, dtype: torch.dtype) -> torch.Tensor:
        """``value`` (a host array) as a ``dtype`` tensor on this replica's
        device, copied once: the first call for (``name``, ``dtype``) queues
        a copy from pinned memory on the current stream (this replica's,
        inside :meth:`launching`) with no wait on the host; later calls
        return the same tensor. Kept per replica, not per device, so that
        each replica's stream orders its own copy before its reads."""
        key = (name, dtype)
        if key not in self.constants:
            self.constants[key] = to_device(value, self.final.device, dtype)
        return self.constants[key]

    def launching(self):
        """The context in which this replica's work is queued: its device and
        stream (nothing on the CPU)."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()


class GeneratorMesh:
    """FinalGenerator over a device list in one process: one replica per
    device (a device may be listed twice: two replicas on one card), every
    replica with the same parameters, each launching on a stream of its own.
    ``n_data`` is the replica count: :meth:`map` splits a batch's rows
    evenly, replica ``i`` taking rows ``[i * n, (i + 1) * n)``, as JAX's
    ``P('data')`` lays a batch out, and returns the replicas' results in row
    order. Each row of the output depends only on its own input row, so the
    rows are the ones a replica computes at its share of the batch."""

    def __init__(self, config: Config, params: dict, devices: list):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.replicas = []
        for device in devices:
            final = FinalGenerator(config, device=device)
            final.load_parameters(params)
            cuda = final.device.type == "cuda"
            if cuda:  # the parameters are on the device before another stream reads them
                torch.cuda.synchronize(final.device)
            self.replicas.append(MeshReplica(
                final, torch.cuda.Stream(final.device) if cuda else None,
                torch.cuda.Stream(final.device) if cuda else None))
        self.n_data = len(self.replicas)

    def map(self, fn, *arrays) -> list:
        """``fn(replica, *rows)`` for each replica on its rows of ``arrays``
        (host or device arrays with the batch first), queued on its device
        and stream; the results in row order. Raises if the rows do not split
        evenly. The replicas' streams do not wait for the default stream nor
        it for them: read the results on the replica's stream
        (:meth:`run`, or ``start_readback`` inside ``replica.launching()``)."""
        b = arrays[0].shape[0]
        if b % self.n_data:
            raise ValueError(f"a batch of {b} rows does not split over {self.n_data} replicas")
        return self._map(self.replicas, fn, arrays)

    def run(self, fn, *arrays) -> dict[str, np.ndarray]:
        """:meth:`map` of ``fn``, which returns a dict of tensors, each
        replica's tensors then read back as f32 numpy arrays on its own
        stream, after the work queued there, and joined in row order. A batch
        whose rows do not split evenly (evaluate's ragged last batch) runs
        whole on the first replica, as JAX replicates it."""
        replicas = self.replicas if arrays[0].shape[0] % self.n_data == 0 else self.replicas[:1]
        parts = []
        for rep, out in zip(replicas, self._map(replicas, fn, arrays)):
            with rep.launching():
                parts.append({k: v.float().cpu().numpy() for k, v in out.items()})
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    @staticmethod
    def _map(replicas: list, fn, arrays) -> list:
        n = arrays[0].shape[0] // len(replicas)
        out = []
        for i, rep in enumerate(replicas):
            with rep.launching():
                out.append(fn(rep, *(a[i * n:(i + 1) * n] for a in arrays)))
        return out

    def synchronize(self) -> None:
        """Wait for all work on every replica's card (``torch.cuda.synchronize``)."""
        for dev in dict.fromkeys(rep.final.device for rep in self.replicas):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
