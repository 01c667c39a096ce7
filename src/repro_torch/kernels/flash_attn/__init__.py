"""Attention kernels."""
