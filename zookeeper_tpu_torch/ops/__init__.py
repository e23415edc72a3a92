"""Ops of the QuickNet paths: quantizers, binary compute (with the CUDA
kernel wrappers), layers, the deployment converter and the device
check the entry points share."""
