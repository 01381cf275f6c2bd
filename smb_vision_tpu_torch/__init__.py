"""PyTorch / CUDA port of smb_vision_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package module for module; the hand-written kernels live
in `csrc/` and are built at first use (`ops/_build.py`)."""
