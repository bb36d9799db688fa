"""Plain PyTorch version of the matmul kernel."""
import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) @ y.to(torch.float32)).to(x.dtype)
