"""Compute ops: the K1 forward kernel wrapper, the exact oracle, the public
attention API and the SDPA adapter."""
