"""Fused end-to-end generation: one image + action class -> T-frame video.

Counterpart of kpvid_tpu/eval/final.py::FinalGenerator:

  pose-encode the input image -> first-frame keypoints (pose_head kernel)
  explicit z -> motion decoder (stacked LSTM) -> T future keypoint frames
  the translator's serving weights (``Translator.serving_weights``, the one
  owner of their layout); 32^2 Gaussian maps (gaussian_render kernel); the
  translator's first conv split so its frame-invariant channels are
  convolved once per sample, its per-frame part, that sum and oct0a's BN +
  ReLU one conv3x3_add_affine launch; the translator decode from oct0b
  (ops/chain.py runs the prepared layers); blend and clip.

The path itself is :class:`GenerateNet`, a module on tensors that
``FinalGenerator.generate`` calls after moving its inputs to the device,
and that the serving artifact traces (eval/export.py).
``render_point_images`` draws evaluate's colorized keypoint images at full
resolution (gaussian_render again, at 128^2).

While a profiler records, generation names its phases (utils/spans.py):
``kpvid.generate`` around ``FinalGenerator.generate``, inside it
``kpvid.generate.inputs`` (the copies to the device), then, each opened once
by ``GenerateNet.forward``, ``.detect``, ``.motion_decode``, ``.first_conv``
(the serving weights and the split first conv), ``.translator`` and
``.blend``; ``kpvid.graph.motion_decode`` inside ``.motion_decode`` around
each replay of :class:`GraphedDecode`. The serving artifact's graph has
none of them.

On the card the motion decode (``MotionGenerator.decode``: 32 steps of a
2-layer LSTM, each step and layer one ``kpvid::lstm_cell`` launch in bf16,
~80 launches at ``Config()``) is replayed from a CUDA graph captured once
per batch shape (:class:`GraphedDecode`), so that the host's launches no
longer pace the call.

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
import copy
import dataclasses
import gc

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Config
from ..device import resolve_device, to_device
from ..models import MotionGenerator, Stage1Generator, init_like_jax
from ..models.networks import FirstLayer
from ..ops.chain import translator_chain
from ..ops.conv3x3 import conv3x3_add_affine
from ..ops.coords import blend, colorize_point_maps
from ..ops.keypoint_kernels import gaussian_render
from ..utils import jax_random
from ..utils.spans import op_span, span


class GraphedDecode:
    """``MotionGenerator.decode`` for :class:`GenerateNet`, replayed from a
    CUDA graph captured once per batch shape and device.

    The graph runs the eager decode's ops in their dtypes (the LSTM kernels
    rounded to the compute dtype inside it), so it reads
    the parameters by address: values copied into them in place
    (``load_state_dict``) show at the next replay; a parameter rebound to
    other storage (``.to``) drops every graph, and the next call captures
    anew. A call copies its inputs into the graph's buffers, replays it on
    the current stream and returns a clone of its output, which no later
    replay overwrites. The captures share one memory pool, so each replay is
    ordered after the last one, on whatever stream that ran.

    The graph is replayed only where the code can tell that it is safe: CUDA
    inputs, grad mode off, no stream capture under way (a graph of the
    caller's, such as the graphed train step), neither ``torch.export`` nor
    ``torch.compile`` tracing (the serving artifact keeps the eager ops), no
    layer of the decoder sharded. Elsewhere the eager decode runs, as it
    does while a profiler records and no graph of the shape exists yet: no
    capture is made under a profiler. A capture follows
    ``train/state.py::StepGraph``: an eager warm-up on a side stream, a sync,
    then the capture with the garbage collector paused, in the
    ``"thread_local"`` error mode, so that other threads' CUDA calls (the
    daemon's readbacks) go on during it.

    ``captures``, ``replays`` and ``eager_calls`` count the calls by path.
    The kernels' launch counters (``ops.launch_counts``) count the warm-up's
    launches and those captured into the graph, and none of a replay's."""

    def __init__(self, stage2: MotionGenerator):
        self.stage2 = stage2
        self.graphs: dict = {}  # (device, input shapes and dtypes) -> (graph, inputs, output)
        self.pool = None
        self.addresses: list[int] = []  # the parameters' storage the graphs read
        self.stream = None  # the stream of the last replay
        self.captures = self.replays = self.eager_calls = 0

    def __deepcopy__(self, memo):
        return type(self)(copy.deepcopy(self.stage2, memo))  # a copy starts with no graph

    def graphable(self, z: torch.Tensor) -> bool:
        s2 = self.stage2
        return (not torch.compiler.is_compiling() and z.is_cuda and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing()
                and not (s2.dec_in.sharded or s2.dec_lstm.sharded or s2.to_coord.sharded))

    def __call__(self, z: torch.Tensor, first_pt: torch.Tensor,
                 act: torch.Tensor) -> torch.Tensor:
        args = (z, first_pt, act)
        if not self.graphable(z):
            self.eager_calls += 1
            return self.stage2.decode(*args)
        addresses = [p.data_ptr() for p in self.stage2.parameters()]
        if addresses != self.addresses:
            self.graphs.clear()
            self.pool, self.addresses = None, addresses
        key = (z.device, tuple((tuple(a.shape), a.dtype) for a in args))
        entry = self.graphs.get(key)
        if entry is None:
            if torch._C._autograd._profiler_enabled():
                self.eager_calls += 1
                return self.stage2.decode(*args)
            entry = self.graphs[key] = self._capture(args)
        graph, inputs, out = entry
        stream = torch.cuda.current_stream(z.device)
        if self.stream is not None and self.stream != stream:
            stream.wait_stream(self.stream)
        self.stream = stream
        with op_span("kpvid.graph.motion_decode"):  # the graph's kernels are linked to it
            for buf, a in zip(inputs, args):
                buf.copy_(a)
            graph.replay()
            result = out.clone()
        self.replays += 1
        return result

    def _capture(self, args: tuple) -> tuple:
        dev = args[0].device
        inputs = [a.clone() for a in args]
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # cuBLAS's handle and workspace, the kernels' libraries: outside the capture
            self.stage2.decode(*inputs)
        current.wait_stream(side)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        try:
            with torch.cuda.device(dev), torch.cuda.graph(graph, pool=self.pool, stream=side,
                                                          capture_error_mode="thread_local"):
                gc.disable()
                out = self.stage2.decode(*inputs)
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        return graph, inputs, out


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
        self.motion_decode = GraphedDecode(stage2)
        self.n_pts = n_pts
        self.n_future = n_future
        self.heatmap_size = heatmap_size
        self.heatmap_inv_std = heatmap_inv_std
        self.dtype = dtype

    def forward(self, im: torch.Tensor, action_code: torch.Tensor,
                z: torch.Tensor) -> dict[str, torch.Tensor]:
        b, hw = im.shape[0], tuple(im.shape[1:3])
        t = self.n_future
        with span("kpvid.generate.detect"):
            current_mu = self.stage1.detect(im)
        first_pt = current_mu.reshape(b, 2 * self.n_pts)
        with span("kpvid.generate.motion_decode"):
            pred_flat = self.motion_decode(z, first_pt, action_code)  # [B, T, 2K]
        future_mu_seq = pred_flat.reshape(b, t, self.n_pts, 2)
        with span("kpvid.generate.first_conv"):
            weights = self.stage1.translator.serving_weights()
            first = self.split_first_conv(im, current_mu, future_mu_seq, weights.first)
        with span("kpvid.generate.translator"):
            crude, mask = translator_chain(first, weights)
        with span("kpvid.generate.blend"):
            im_t = im.float().repeat_interleave(t, dim=0)
            final = torch.clamp(blend(im_t, crude, mask), -1.0, 1.0)
            crude = torch.clamp(crude, -1.0, 1.0)
            return {
                "im": im,
                "pred_im_seq": final.reshape(b, t, *hw, 3),
                "mask": mask.reshape(b, t, *hw, 1),
                "pred_im_crude": crude.reshape(b, t, *hw, 3),
                "current_points": current_mu,
                "future_points": future_mu_seq,
                "fut_pt_raw": future_mu_seq,
            }

    def split_first_conv(self, im, current_mu, future_mu_seq, first: FirstLayer) -> torch.Tensor:
        """The translator's first layer (oct0a: conv, BN, ReLU) for all B*T
        frames, in the compute dtype, from ``first`` of
        ``Translator.serving_weights()``. The conv's input channels are
        [embedding ++ current map ++ future map]; the first two are the same
        for every frame of a sample, so they are convolved once per sample
        (exact by linearity), with the bias, and kept in f32. One
        conv3x3_add_affine launch convolves each frame's future map, adds
        its sample's part and applies oct0a's BN and ReLU, in f32 until the
        one rounding."""
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
        y_static = F.conv2d(static.permute(0, 3, 1, 2), first.static_kernel, padding=1)
        y_static = y_static.permute(0, 2, 3, 1).float() + first.bias  # [B, h, w, F]
        return conv3x3_add_affine(fut_map, first.frame_kernel, y_static, first.scale, first.shift)


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
