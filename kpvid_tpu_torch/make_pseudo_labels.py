"""Per-frame keypoint pseudo-labels from a stage-1 pose encoder.

    python -m kpvid_tpu_torch.make_pseudo_labels --config kpvid_tpu_torch/configs/penn.yaml \
        --checkpoint stage1.npz

Counterpart of the JAX package's ``make_pseudo_labels.py``.
Writes ``<data_dir>/pseudo_labels/{video_id:04d}.npy`` of shape
[n_frames, K, 2] (f32, x and y in [-1, 1]) for every train and test video.
``--checkpoint`` is the port's stage-1 parameter file
(``tools/export_torch_params.py``), a stage-1 trainer checkpoint
``ckpt-N`` (``python -m kpvid_tpu_torch.train --mode detector_translator``),
or the directory above its checkpoints (the newest); only its
``stage1.pose_encoder.*`` tensors are read. It runs on the card and raises without one
(``--device cpu`` runs the plain versions on the CPU).

The whole job is one frame stream: a background thread decodes the next
videos while the card labels the current slab; frames pack into
``data.labeler_chunk``-frame slabs across video boundaries
(data/keypoint.py); slabs travel to the card as uint8 and are mapped to
[-1, 1] there with the JAX formula (f32, / 255, * 2, - 1); the pose encoder
ends in the ``pose_head`` soft-argmax kernel, one launch a slab; two slabs
stay in flight while the [chunk, K, 2] results come back on a second
stream, and each video is saved as soon as its last row is back.

Several processes (the KPVID_* environment, parallel/distributed.py), one
card each: each labels its stride of each split's videos (process ``i`` of
``N`` takes videos ``i, i + N, ...``) into the shared ``pseudo_labels/``,
with no collective; the first writes the synthetic tree while the others
wait, and all wait at the end until every label file is written.
"""

from __future__ import annotations

import collections
import time
from argparse import ArgumentParser
from os import path as osp

import numpy as np
import torch


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="kpvid_tpu_torch pseudo-labeler")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="the port's stage-1 parameter file (.npz) or trainer ckpt-N")
    parser.add_argument("--synthetic", action="store_true",
                        help="write a synthetic Penn-Action tree into data_dir first")
    parser.add_argument("--chunk", type=int, default=None,
                        help="frames per device chunk (default: config data.labeler_chunk)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain versions")
    return parser


def load_pose_encoder(config, checkpoint: str, device: torch.device):
    """The stage-1 pose encoder with the ``stage1.pose_encoder.*`` tensors of
    a parameter file or trainer checkpoint merged in by name into JAX's
    ``Stage1Generator.init(PRNGKey(0))`` tree; returns (encoder, tensors
    matched)."""
    from torch import nn

    from .checkpoint import load_parameters, merge_parameters, resolve_parameter_file
    from .models import PoseEncoder, init_like_jax
    from .utils import jax_random

    m = config.model
    dtype = torch.bfloat16 if config.training.compute_dtype == "bfloat16" else torch.float32
    enc = PoseEncoder(m.n_pts, m.image_size, m.pose_decoder_filters, m.encoder_filters, dtype)
    prefix = "stage1.pose_encoder."
    holder = nn.ModuleDict({"stage1": nn.ModuleDict({"pose_encoder": enc})})
    target = init_like_jax(holder, {"stage1": jax_random.PRNGKey(0)})
    merged, n = merge_parameters(
        target, load_parameters(resolve_parameter_file(checkpoint, "--checkpoint")))
    enc.load_state_dict({k[len(prefix):]: v for k, v in merged.items()}, strict=True)
    return enc.to(device).eval(), n


def detect_u8(enc, frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 frames [N, S, S, 3] on the device -> keypoints [N, K, 2] f32."""
    return enc(frames_u8.float() / 255.0 * 2.0 - 1.0)


def main(argv=None) -> dict:
    """Label every video; returns the run's counts and seconds."""
    args = build_parser().parse_args(argv)
    from .parallel import barrier, is_primary, maybe_initialize, world

    multiproc = maybe_initialize(args.device)
    rank, n_proc = world()
    from .configs import load_config
    from .data import VideoFramesDataset, make_synthetic_penn_tree, pack_chunks, prefetch_videos
    from .device import resolve_device, start_readback, to_device
    from .utils import logger, setup_console_logging, touch_dir

    setup_console_logging()
    device = resolve_device(args.device)
    config = load_config(args.config)
    m_cfg = config.model
    data_dir = config.paths.data_dir
    if args.synthetic:
        if is_primary():  # one writer on a shared filesystem
            make_synthetic_penn_tree(data_dir)
        barrier("kpvid_labeler_synthetic")
    chunk = args.chunk or config.data.labeler_chunk
    out_dir = touch_dir(osp.join(data_dir, "pseudo_labels"))
    enc, n = load_pose_encoder(config, args.checkpoint, device)
    logger.info("restored %d tensors from %s", n, args.checkpoint)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    decode_s = 0.0  # seconds the decode thread spent in load_video

    def all_videos():
        nonlocal decode_s
        for subset in ("train", "test"):
            ds = VideoFramesDataset(data_dir, subset, image_size=m_cfg.image_size,
                                    as_uint8=True, native_ops=config.data.native_ops)
            if is_primary():
                logger.info("%s set: %d videos", subset, len(ds))
            for idx in range(rank, len(ds), n_proc):  # this process's stride
                t0 = time.perf_counter()
                frames = ds.load_video(idx)
                decode_s += time.perf_counter() - t0
                yield ds.video_id(idx), frames.shape[0], frames

    buffers: dict[int, np.ndarray] = {}
    remaining: dict[int, int] = {}
    stats = {"videos": 0, "frames": 0, "chunks": 0}

    def drain(inflight):
        """Wait for the oldest slab's readback, scatter its rows into the
        per-video buffers and save the videos it completes."""
        readback, segs = inflight.popleft()
        pts = readback.wait()["points"]  # [chunk, K, 2]
        for vid, n_frames, v_off, s_off, count in segs:
            if vid not in buffers:
                buffers[vid] = np.empty((n_frames, m_cfg.n_pts, 2), np.float32)
                remaining[vid] = n_frames
            buffers[vid][v_off : v_off + count] = pts[s_off : s_off + count]
            remaining[vid] -= count
            if remaining[vid] == 0:
                np.save(osp.join(out_dir, f"{vid:04d}.npy"), buffers.pop(vid))
                del remaining[vid]
                stats["videos"] += 1
                stats["frames"] += n_frames

    inflight: collections.deque = collections.deque()
    wait_s = 0.0  # seconds the labeling loop waited for the next slab
    t_start = time.perf_counter()
    slabs = pack_chunks(prefetch_videos(all_videos(), depth=2), chunk)
    with torch.no_grad():
        while True:
            t0 = time.perf_counter()
            item = next(slabs, None)
            wait_s += time.perf_counter() - t0
            if item is None:
                break
            slab, segs = item
            pts = detect_u8(enc, to_device(slab, device))
            inflight.append((start_readback({"points": pts}, copy_stream), segs))
            stats["chunks"] += 1
            if len(inflight) > 2:  # keep two slabs in flight
                drain(inflight)
        while inflight:
            drain(inflight)
    if remaining:
        raise RuntimeError(f"incomplete videos: {sorted(remaining)}")
    seconds = time.perf_counter() - t_start
    logger.info("labeled %d videos / %d frames in %d chunks of %d in %.2fs (%.1f frames/s); "
                "decode %.2fs, waiting for slabs %.2fs%s",
                stats["videos"], stats["frames"], stats["chunks"], chunk, seconds,
                stats["frames"] / max(seconds, 1e-9), decode_s, wait_s,
                f" [process {rank}/{n_proc}]" if multiproc else "")
    # every shard's labels are on disk before any process (a chained
    # stage-2 run) reads the directory
    barrier("kpvid_labeler_done")
    return dict(stats, chunk=chunk, seconds=seconds, decode_seconds=decode_s,
                wait_seconds=wait_s, out_dir=str(out_dir))


if __name__ == "__main__":
    main()
