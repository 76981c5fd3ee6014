"""Numerics of the port: precision policies and the Table-1 GEMM-Ops."""
