"""PyTorch/CUDA port of kpvid_tpu for an NVIDIA H100.

Unsupervised-keypoint-guided, class-conditional video prediction: one image
plus an action class gives a 32-frame video. The JAX package ``kpvid_tpu``
stays the reference; this package imports nothing of it and none of JAX.
Its kernels are hand-written for Hopper (``csrc/`` in CUDA C++,
``ops/keypoint_kernels.py`` in Triton); each has a plain PyTorch version
beside it, which its wrapper takes for tensors on the CPU.
"""
