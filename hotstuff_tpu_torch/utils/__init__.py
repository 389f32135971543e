"""Helpers of the port: device selection and the CUDA kernel build."""
