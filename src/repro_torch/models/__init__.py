"""Model stacks of the port: the decoder-only LM transformer (dense and
MoE), the recommenders (Wide & Deep, DCN-v2) and the GNNs (``gnn``)."""
from __future__ import annotations

import numpy as np
import torch


def params_from_arrays(tree):
    """The port's parameters, on the CPU, from the reference's, given as
    nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray,
    params)``); ``None`` leaves (an empty subtree in JAX) stay ``None``:
    the model-side counterpart of ``storage.database_from_arrays``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_arrays(v) for v in tree)
    return torch.from_numpy(np.array(tree))
