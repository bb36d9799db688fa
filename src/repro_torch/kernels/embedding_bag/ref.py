"""Plain PyTorch version of the embedding-bag kernel: gather + masked
weighted sum (index -1 = padding, weight 0)."""
import torch


def embedding_bag_ref(table, indices, weights=None):
    valid = indices >= 0
    if weights is None:
        weights = valid.to(torch.float32)
    else:
        weights = weights * valid
    rows = table[indices.clamp_min(0).long()]          # (n_bags, bag, D)
    return (rows.to(torch.float32) * weights[..., None]).sum(1)
