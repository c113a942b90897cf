"""Connected-component labelling and the DB postprocess device front half —
port of pytorchocr_tpu/ops/cc_label.py (spread_labels_scan,
connected_components, db_front_half).

prob map -> threshold -> CC labels (alternating segmented run-max scans, the
hand-written kernel of ops/runmax.py on the card) -> sort-free compact
relabel -> per-label count / prob sum (bincount, index_add_) and bbox (one
packed scatter amin). Only the int16 labels and the per-label stats cross to
the host.

Not ported yet (ROADMAP.md A.10): pse_expand_device and pa_aggregate_device,
which need the K2 propagation kernel.
"""

import torch

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
