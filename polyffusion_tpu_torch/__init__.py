"""PyTorch and CUDA port of ``polyffusion_tpu`` for an NVIDIA H100.

It imports nothing of JAX or of ``polyffusion_tpu``; its entry points run on the
GPU unless they are given ``device="cpu"``.
"""
