"""Plain PyTorch versions of the flash attention kernel: masked multi-head
attention with GQA (KV heads repeated), fp32 scores, a ``-inf`` mask and
``nan_to_num`` (a fully masked row gives 0), output in q's dtype; and the
same attention split over the KV axis and combined, as the kernel's
split-KV path computes it."""
import torch

from .flash_attention import split_size

NEG_INF = -1e30


def _scores_and_mask(q, k, lengths, causal):
    b, h, sq, dh = q.shape
    _, hk, skv, _ = k.shape
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    kf = k.repeat_interleave(h // hk, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * dh ** -0.5
    lens = lengths.to(q.device)[:, None, None, None]
    kpos = torch.arange(skv, device=q.device)[None, None, None, :]
    mask = kpos < lens
    if causal:
        qpos = (lens - sq) + torch.arange(sq, device=q.device)[None, None, :,
                                                                 None]
        mask = mask & (qpos >= kpos)
    return s, mask, kpos


def flash_attention_ref(q, k, v, lengths=None, *, causal: bool = True):
    s, mask, _ = _scores_and_mask(q, k, lengths, causal)
    vf = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.exp(s - s.amax(-1, keepdim=True)))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def flash_attention_split_ref(q, k, v, lengths=None, *, causal: bool = True,
                              splits: int = 1):
    """Split s covers keys [s * n, (s + 1) * n), n = ``split_size(skv,
    splits)``. Each split's partial is the kernel's: m the max of its
    masked scores (-1e30 where it sees no key), l = sum p and acc = p V with
    p = exp(s - m) * mask, so a split wholly past the length gives m =
    -1e30, l = 0, acc = 0. The partials combine by the log-sum-exp rule
    (weights exp(m_s - max m)); a row whose total l is 0 outputs 0."""
    s, mask, kpos = _scores_and_mask(q, k, lengths, causal)
    vf = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    n = split_size(k.shape[2], splits)
    ms, ls, accs = [], [], []
    for sp in range(splits):
        live = mask & (kpos >= sp * n) & (kpos < (sp + 1) * n)
        ss = s.masked_fill(~live, NEG_INF)
        m = ss.amax(-1, keepdim=True)
        p = torch.exp(ss - m) * live
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p, vf))
    m_all = torch.stack(ms)
    w = torch.exp(m_all - m_all.amax(0))
    total = (w * torch.stack(ls)).sum(0)
    acc = (w * torch.stack(accs)).sum(0)
    return (acc / torch.where(total == 0, 1.0, total)).to(q.dtype)
