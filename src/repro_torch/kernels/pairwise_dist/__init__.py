"""Pairwise squared-L2 distances between flattened models (grouping): a CUDA
kernel and its plain PyTorch version."""
from repro_torch.kernels.pairwise_dist.ops import (dist_to_ref,
                                                   model_pairwise_dist,
                                                   pairwise_dist,
                                                   pairwise_dist_sq)
