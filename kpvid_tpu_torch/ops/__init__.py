from .chain import translator_chain
from .conv3x3 import (
    conv3x3_affine,
    conv3x3_affine_plain,
    fold_bn,
    up2_conv3_affine,
    up2_conv3_affine_plain,
)
from .coords import blend, grid, heatmaps_to_keypoints, render_gaussian_maps, soft_argmax_1d
from .keypoint_kernels import gaussian_render, pose_head
from .resize import up2_conv3, upsample2x

# every kernel wrapper of the port, by name; each counts its launches
KERNELS = {
    "conv3x3_affine": conv3x3_affine,
    "up2_conv3_affine": up2_conv3_affine,
    "pose_head": pose_head,
    "gaussian_render": gaussian_render,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "blend",
    "conv3x3_affine",
    "conv3x3_affine_plain",
    "fold_bn",
    "gaussian_render",
    "grid",
    "heatmaps_to_keypoints",
    "launch_counts",
    "pose_head",
    "render_gaussian_maps",
    "reset_launch_counts",
    "soft_argmax_1d",
    "translator_chain",
    "up2_conv3",
    "up2_conv3_affine",
    "up2_conv3_affine_plain",
    "upsample2x",
]
