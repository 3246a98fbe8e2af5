from .fused_topk import fused_topk
from .matmul import pairwise_matmul

__all__ = ["fused_topk", "pairwise_matmul"]
