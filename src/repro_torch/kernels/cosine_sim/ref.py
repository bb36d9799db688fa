"""Plain PyTorch version of cosine similarity."""
import torch


def cosine_sim_ref(x: torch.Tensor, y: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xn = x / torch.sqrt(torch.sum(x * x, -1, keepdim=True) + eps)
    yn = y / torch.sqrt(torch.sum(y * y, -1, keepdim=True) + eps)
    return xn @ yn.T
