from . import library  # registers the torch.ops.kpvid ops
from .chain import translator_chain
from .conv3x3 import (
    conv3x3_affine,
    conv3x3_affine_plain,
    fold_bn,
    up2_conv3_affine,
    up2_conv3_affine_plain,
)
from .coords import blend, colorize_point_maps, grid, heatmaps_to_keypoints, render_gaussian_maps, soft_argmax_1d
from .keypoint_kernels import (
    gaussian_render,
    gaussian_render_backward,
    pose_head,
    pose_head_backward,
)
from .resize import up2_conv3, upsample2x

# every kernel wrapper of the port, by name; each counts its launches
KERNELS = {
    "conv3x3_affine": conv3x3_affine,
    "up2_conv3_affine": up2_conv3_affine,
    "pose_head": pose_head,
    "gaussian_render": gaussian_render,
    "pose_head_backward": pose_head_backward,
    "gaussian_render_backward": gaussian_render_backward,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "blend",
    "colorize_point_maps",
    "conv3x3_affine",
    "conv3x3_affine_plain",
    "fold_bn",
    "gaussian_render",
    "gaussian_render_backward",
    "grid",
    "heatmaps_to_keypoints",
    "launch_counts",
    "pose_head",
    "pose_head_backward",
    "render_gaussian_maps",
    "reset_launch_counts",
    "soft_argmax_1d",
    "translator_chain",
    "up2_conv3",
    "up2_conv3_affine",
    "up2_conv3_affine_plain",
    "upsample2x",
]
