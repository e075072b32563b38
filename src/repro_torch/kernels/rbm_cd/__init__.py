"""The RBM's fused GEMM + bias + sigmoid: the Hopper kernel K8 and its plain
version."""
from .ops import gemm_sigmoid, gemm_sigmoid_plain  # noqa: F401
