"""Plain PyTorch version of the pairwise_dist kernel: the same Gram
formulation as the TPU kernel (row norms plus one ``X Xᵀ`` product), in
f32."""
import torch


def pairwise_dist_sq_ref(x: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (M, M) squared distances ``n_i + n_j - 2 x_i·x_j``,
    clamped at 0."""
    n = (x * x).sum(dim=1)
    return torch.clamp(n[:, None] + n[None, :] - 2.0 * (x @ x.T), min=0.0)
