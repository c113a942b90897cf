"""Host expansions of the PSE and PAN postprocesses — the port's copy of
pytorchocr_tpu/ops/propagate.py:31-140 (`_spread_once_np`, `_propagate_np`,
`pse_np`, `pa_np`; numpy and cv2 only), so that the port imports nothing of
the JAX package. They serve `use_device_expand=False` (PSEPostProcess) and
`use_device_aggregate=False` (PANPostProcess).

Components are numbered by cv2 from their first raster pixel, unlike the
device path (divergence 2, ROADMAP.md C).
"""

import cv2
import numpy as np


def _spread_once_np(labels, mask, emb=None, mean_emb=None, gate=None, emb_thresh=3.0):
    """One round in place: unlabelled masked pixels take a neighbour's label,
    the four directions one after another. From propagate.py:31."""
    changed = False
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        nb = np.zeros_like(labels)
        if dx == -1:
            nb[:-1] = labels[1:]
        elif dx == 1:
            nb[1:] = labels[:-1]
        elif dy == -1:
            nb[:, :-1] = labels[:, 1:]
        else:
            nb[:, 1:] = labels[:, :-1]
        cand = (labels == 0) & mask & (nb > 0)
        if emb is not None and gate is not None:
            idx = np.where(cand)
            if idx[0].size:
                lbl = nb[idx]
                gated = gate[lbl]
                if gated.any():
                    d = np.linalg.norm(emb[:, idx[0], idx[1]].T - mean_emb[lbl], axis=1)
                    keep = ~gated | (d <= emb_thresh)
                    cand_idx = (idx[0][keep], idx[1][keep])
                    if cand_idx[0].size:
                        labels[cand_idx] = nb[cand_idx]
                        changed = True
                    continue
            if idx[0].size:
                labels[idx] = nb[idx]
                changed = True
            continue
        if cand.any():
            labels[cand] = nb[cand]
            changed = True
    return changed


def _propagate_np(labels, mask, emb=None, mean_emb=None, gate=None, emb_thresh=3.0):
    """Spread labels to a fixpoint within mask. From propagate.py:71."""
    for _ in range(max(labels.shape) * 2):
        if not _spread_once_np(labels, mask, emb, mean_emb, gate, emb_thresh):
            break
    return labels


def pse_np(kernels, min_area):
    """Progressive scale expansion (pse.pyx semantics): `kernels` (K, H, W)
    uint8 ordered big..small. Returns the int32 label map. From
    propagate.py:79."""
    kernel_num = kernels.shape[0]
    label_num, label = cv2.connectedComponents(kernels[-1], connectivity=4)
    label = label.astype(np.int32)

    if min_area > 0:
        counts = np.bincount(label.ravel(), minlength=label_num)
        small = np.where(counts < min_area)[0]
        if small.size:
            wipe = np.isin(label, small[small > 0])
            label[wipe] = 0

    for kernel_idx in range(kernel_num - 2, -1, -1):
        _propagate_np(label, kernels[kernel_idx] > 0)
    return label


def pa_np(kernels, emb, min_area=0):
    """Pixel aggregation (pa.pyx semantics): `kernels` (2, H, W) uint8 =
    [text, kernel], `emb` (4, H, W) float32. Labels grow from the kernel
    components into the text region; labels flagged by the extreme-area-ratio
    test also need ||emb - mean_emb|| <= 3. From propagate.py:101."""
    _, cc = cv2.connectedComponents(kernels[0], connectivity=4)
    label_num, label = cv2.connectedComponents(kernels[1], connectivity=4)
    label = label.astype(np.int32)

    mean_emb = np.zeros((label_num, emb.shape[0]), dtype=np.float32)
    area = np.full((label_num,), -1, dtype=np.float32)
    flag = np.zeros((label_num,), dtype=bool)
    rep = np.zeros((label_num, 2), dtype=np.int64)

    max_rate = 1024.0
    for i in range(1, label_num):
        ind = label == i
        area[i] = ind.sum()
        if area[i] < min_area:
            label[ind] = 0
            continue
        px, py = np.where(ind)
        rep[i] = (px[0], py[0])
        for j in range(1, i):
            if area[j] < min_area:
                continue
            if cc[rep[i, 0], rep[i, 1]] != cc[rep[j, 0], rep[j, 1]]:
                continue
            rate = area[i] / area[j]
            if rate < 1 / max_rate or rate > max_rate:
                flag[i] = True
                mean_emb[i] = emb[:, label == i].mean(axis=1)
                if not flag[j]:
                    flag[j] = True
                    mean_emb[j] = emb[:, label == j].mean(axis=1)

    _propagate_np(label, kernels[0] > 0, emb=emb, mean_emb=mean_emb, gate=flag)
    return label
