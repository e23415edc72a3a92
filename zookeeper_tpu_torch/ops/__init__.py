"""Ops of the packed inference path: quantizers, binary compute (with
the CUDA kernel wrappers), layers and the deployment converter."""
