"""Attention ops of the port: plain PyTorch versions and Hopper kernels
(``ops.flash_attention``; CUDA sources under ``ops/csrc``)."""
