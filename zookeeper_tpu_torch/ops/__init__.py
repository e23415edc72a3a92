"""Ops of the binary zoo and TransformerLM paths: quantizers, binary
compute and attention (with the CUDA kernel wrappers), layers, the
deployment converter and the device check the entry points share."""
