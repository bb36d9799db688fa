"""Plain PyTorch version of the flash attention kernel: masked multi-head
attention with GQA (KV heads repeated), fp32 scores, a ``-inf`` mask and
``nan_to_num`` (a fully masked row gives 0), output in q's dtype."""
import torch


def flash_attention_ref(q, k, v, lengths=None, *, causal: bool = True):
    b, h, sq, dh = q.shape
    _, hk, skv, _ = k.shape
    group = h // hk
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * dh ** -0.5
    lens = lengths.to(q.device)[:, None, None, None]
    kpos = torch.arange(skv, device=q.device)[None, None, None, :]
    mask = kpos < lens
    if causal:
        qpos = (lens - sq) + torch.arange(sq, device=q.device)[None, None, :,
                                                                 None]
        mask = mask & (qpos >= kpos)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.exp(s - s.amax(-1, keepdim=True)))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
