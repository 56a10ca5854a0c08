"""Utilities: the nvcc/ctypes kernel builder and testing helpers."""
