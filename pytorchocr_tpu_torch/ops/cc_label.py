"""Connected-component labelling and the detection postprocesses' device
parts — port of pytorchocr_tpu/ops/cc_label.py (spread_labels_scan,
connected_components, db_front_half, pse_expand_device, pa_aggregate_device).

DB: prob map -> threshold -> CC labels (alternating segmented run-max scans,
the hand-written kernel of ops/runmax.py on the card) -> sort-free compact
relabel -> per-label count / prob sum (bincount, index_add_) and bbox (one
packed scatter amin). Only the int16 labels and the per-label stats cross to
the host.

PSE: CC of the smallest kernel, min-area filter, then one fill fixpoint per
larger kernel (the hand-written kernel of ops/propagate.py on the card).
PAN: CC of the kernel map, min-area filter, the extreme-area-ratio gate
within one text component, then a gated fill into the text map (torch ops).
"""

import torch
import torch.nn.functional as F

from .propagate import spread_labels_fixpoint
from .runmax import segmented_runmax

alternations = 0  # row+column alternations run by spread_labels_scan


def spread_labels_scan(labels, mask):
    """Spread labels to the per-component max via alternating row/column
    segmented run-max scans, until a whole alternation changes nothing.

    The JAX version is a device while_loop. Here each alternation reads the
    changed flag (set by the axis-0 launch) on the host: one `.item()` sync
    per alternation. That sync is where latency will be found later; a
    persistent kernel running the whole fixpoint would remove it.
    """
    global alternations
    lbl = labels
    while True:
        l1 = segmented_runmax(lbl, mask, axis=1)
        l2, changed = segmented_runmax(l1, mask, axis=0, prev=lbl)
        alternations += 1
        if not changed.item():
            return l2
        lbl = l2


def connected_components(binary, max_labels=1024):
    """4-connected components of a (H, W) bool map.

    Returns (labels, num): labels int32 (H, W) in [0, max_labels), 0 =
    background, components numbered from 1 in raster order of their seed
    pixel; components past max_labels - 1 clamp into the last slot, and num
    is clamped the same way (as in the JAX version).
    """
    h, w = binary.shape
    binary = binary.contiguous()
    idx = torch.arange(1, h * w + 1, dtype=torch.int32, device=binary.device)
    labels = torch.where(binary, idx.view(h, w), 0)
    labels = spread_labels_scan(labels, binary)

    # a pixel is its component's representative iff its final label is its
    # own seed index; the compact id is the representative's rank
    flat = labels.view(-1)
    ranks = torch.cumsum((flat == idx).to(torch.int32), 0, dtype=torch.int32)
    compact = torch.where(flat > 0, ranks[(flat - 1).clamp_min(0).long()], 0)
    compact = compact.clamp(0, max_labels - 1).view(h, w)
    num = ranks[-1].clamp(max=max_labels - 1)
    return compact.to(torch.int32), num


def db_front_half(prob, thresh=0.3, max_labels=1024):
    """Device front half of DBPostProcess for one (H, W) prob map.

    Returns a dict of labels (H, W) int16, num (), count (max_labels,) f32,
    score (max_labels,) f32 mean prob per component, bbox (max_labels, 4)
    int32 xmin, ymin, xmax, ymax. Counts are exact (bincount); prob sums are
    taken in float64 and rounded once, so the score is the f32 mean.
    """
    h, w = prob.shape
    labels, num = connected_components(prob > thresh, max_labels)
    flat = labels.view(-1).long()
    count = torch.bincount(flat, minlength=max_labels).to(torch.float32)
    psum = torch.zeros(max_labels, dtype=torch.float64, device=prob.device)
    psum.index_add_(0, flat, prob.reshape(-1).to(torch.float64))
    score = (psum / count.clamp_min(1.0).to(torch.float64)).to(torch.float32)

    # all four extremes in one scatter amin of the packed [x, y, -x, -y];
    # empty slots keep int32 max, as jax.ops.segment_min leaves them
    ys = torch.arange(h, dtype=torch.int32, device=prob.device).repeat_interleave(w)
    xs = torch.arange(w, dtype=torch.int32, device=prob.device).repeat(h)
    big = 1 << 30
    stacked = torch.stack([xs, ys, -xs, -ys], dim=1)
    stacked = torch.where((flat > 0)[:, None], stacked, big)
    mins = torch.full(
        (max_labels, 4), torch.iinfo(torch.int32).max, dtype=torch.int32,
        device=prob.device,
    )
    mins.scatter_reduce_(0, flat[:, None].expand(-1, 4), stacked, "amin",
                         include_self=False)
    bbox = torch.stack([mins[:, 0], mins[:, 1], -mins[:, 2], -mins[:, 3]], dim=1)
    return {
        "labels": labels.to(torch.int16),
        "num": num,
        "count": count,
        "score": score,
        "bbox": bbox,
    }


def _min_area_filter(labels, min_area, max_labels):
    """Zero the components of fewer than `min_area` pixels (and slot 0).
    Returns (labels, counts f32 (max_labels,), valid bool (max_labels,)).
    Counts are exact; `min_area` is compared in float32, as the JAX version
    compares its traced float32."""
    counts = torch.bincount(labels.view(-1).long(), minlength=max_labels).to(torch.float32)
    valid = counts >= torch.tensor(min_area, dtype=torch.float32)
    valid[0] = False
    labels = torch.where(valid[labels.long()], labels, 0)
    return labels, counts, valid


def pse_expand_device(kernels, min_area, max_labels=1024):
    """Progressive scale expansion (pse.pyx semantics): `kernels` (K, H, W)
    bool ordered big..small. CC on the smallest kernel, the min-area filter,
    then a fill fixpoint through kernels K-2 .. 0. Returns int32 (H, W)."""
    labels, _ = connected_components(kernels[-1], max_labels)
    labels, _, _ = _min_area_filter(labels, min_area, max_labels)
    for k in range(kernels.shape[0] - 2, -1, -1):
        labels = spread_labels_fixpoint(labels, kernels[k], fill_only=True)
    return labels


def pa_gate(kernels, emb, min_area, max_labels=256):
    """The part of pa_aggregate_device before its fill: `kernels` (2, H, W)
    bool = [text, kernel], `emb` (D, H, W) float32. Returns (labels int32
    (H, W) of the kept kernel components, flag bool (L,): the label is in an
    extreme-area-ratio pair within one text component, so its fill is
    gated, mean_emb f32 (L, D): the label's mean kernel embedding)."""
    labels, _ = connected_components(kernels[1], max_labels)
    labels, counts, valid = _min_area_filter(labels, min_area, max_labels)
    flat = labels.view(-1).long()

    # text-CC id of each label (labels live inside text components); empty
    # slots keep int32 min, as jax.ops.segment_max leaves them
    cc_text, _ = connected_components(kernels[0], max_labels * 4)
    text_of = torch.full((max_labels,), torch.iinfo(torch.int32).min,
                         dtype=torch.int32, device=labels.device)
    text_of.scatter_reduce_(0, flat, cc_text.view(-1), "amax", include_self=False)

    # mean kernel embedding per label, summed in float64 and rounded once
    d = emb.shape[0]
    sums = torch.zeros((max_labels, d), dtype=torch.float64, device=emb.device)
    sums.index_add_(0, flat, emb.reshape(d, -1).t().to(torch.float64))
    mean_emb = (sums / counts.clamp_min(1.0)[:, None].to(torch.float64)).to(torch.float32)

    max_rate = 1024.0
    rate = counts[:, None] / counts[None, :].clamp_min(1.0)
    extreme = (rate > max_rate) | (rate < 1.0 / max_rate)
    same_cc = text_of[:, None] == text_of[None, :]
    eye = torch.eye(max_labels, dtype=torch.bool, device=labels.device)
    pair = valid[:, None] & valid[None, :] & same_cc & extreme & ~eye
    return labels, pair.any(dim=1), mean_emb


def pa_aggregate_device(kernels, emb, min_area, max_labels=256, emb_thresh=3.0):
    """Pixel aggregation (pa.pyx semantics): the kernel components of
    `pa_gate` grow into the text map; a pixel takes a neighbour's label only
    if the label is unflagged or the pixel's embedding lies within
    `emb_thresh` of the label's mean. Synchronous rounds of torch ops until
    one changes nothing (one `.item()` per round). Returns int32 (H, W)."""
    labels, flag, mean_emb = pa_gate(kernels, emb, min_area, max_labels)
    text = kernels[0]
    emb_hw = emb.permute(1, 2, 0)  # (H, W, D)
    while True:
        p = F.pad(labels, (1, 1, 1, 1))
        best = torch.zeros_like(labels)
        for nb in (p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]):
            nbl = nb.long()
            dist = torch.linalg.vector_norm(emb_hw - mean_emb[nbl], dim=-1)
            ok = (nb > 0) & (~flag[nbl] | (dist <= emb_thresh))
            best = torch.maximum(best, torch.where(ok, nb, 0))
        new = torch.where((labels == 0) & text, best, labels)
        if not (new != labels).any().item():
            return new
        labels = new
