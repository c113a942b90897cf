"""CTC greedy collapse on the device — port of
pytorchocr_tpu/ops/ctc_decode.py:ctc_greedy_collapse, in torch ops.

argmax -> keep = (c_t != blank) & (c_t != c_{t-1}) -> scatter the kept codes
to their cumsum positions. Only (codes, lengths, conf) cross to the host.
"""

import torch


def ctc_greedy_collapse(probs, max_len=64):
    """probs (N, T, C) -> codes (N, max_len) int32 (-1 padded), lengths (N,)
    int32, conf (N,) f32 = mean of the per-step max prob over the kept steps
    (dedup first, blanks dropped after, as the reference decodes)."""
    n, t, _ = probs.shape
    idx = probs.argmax(dim=2).to(torch.int32)  # first maximum, as jnp.argmax
    val = probs.amax(dim=2).to(torch.float32)
    prev = torch.cat([torch.full_like(idx[:, :1], -1), idx[:, :-1]], dim=1)
    keep = (idx != 0) & (idx != prev)
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    # dropped and overflowing steps go to a spare column max_len, cut below
    tgt = torch.where(keep & (pos < max_len), pos, max_len).long()
    codes = torch.full((n, max_len + 1), -1, dtype=torch.int32, device=probs.device)
    codes.scatter_(1, tgt, idx)
    lengths = keep.sum(dim=1).clamp(max=max_len).to(torch.int32)
    conf_sum = torch.where(keep, val, 0.0).sum(dim=1)
    conf = torch.where(lengths > 0, conf_sum / lengths.clamp(min=1), 0.0)
    return codes[:, :max_len], lengths, conf
