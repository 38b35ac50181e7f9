"""Tokenization ops of the torch port: plain torch, kernels and tables."""
