"""Plain PyTorch version of random-access matrix generation."""
import torch


def matgen_ref(rows, vals, n_features: int, mode: str = "multi_hot"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """rows, vals: (P,) group ids and values of P pairs. Returns the (N,
    n_features) float32 matrix with one row per distinct group id in
    ascending order, where each pair with 0 <= value < n_features sets its
    column to 1 (``multi_hot``) or adds 1 to it (any other mode), and the N
    group ids."""
    rows, vals = torch.as_tensor(rows), torch.as_tensor(vals)
    groups, row_idx = torch.unique(rows, sorted=True, return_inverse=True)
    out = torch.zeros((groups.numel(), n_features), dtype=torch.float32,
                      device=rows.device)
    ok = (vals >= 0) & (vals < n_features)
    out.index_put_((row_idx[ok], vals[ok].long()),
                   torch.ones((), dtype=torch.float32, device=rows.device),
                   accumulate=True)
    if mode == "multi_hot":
        out.clamp_(max=1.0)
    return out, groups
