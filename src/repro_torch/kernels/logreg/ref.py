"""Plain PyTorch version of the fused logistic-regression gradient."""
import torch
import torch.nn.functional as F


def logreg_grad_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    z = x @ w
    p = torch.sigmoid(z)
    grad = x.T @ (p - y) / x.shape[0]
    loss = torch.mean(F.softplus(z) - y * z)
    return grad, loss
