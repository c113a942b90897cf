"""Label propagation, 16 synchronous rounds per launch (K2) — port of
pytorchocr_tpu/ops/pallas_propagate.py:propagate_rounds_pallas and
spread_labels_fixpoint.

One round of masked 4-neighbour label-max spreading on an int32 (H, W) map,
neighbours outside the map counting as 0, `best` = max(self, 4 neighbours):
  fill_only=True  (PSE/PAN expansion): unlabelled masked pixels take `best`;
  fill_only=False (CC rule): every masked pixel takes `best`, others 0.
A launch runs ROUNDS of them and reports whether the last round changed
anything: a round that changes nothing is a fixpoint.

On a CUDA tensor `propagate_rounds` launches the hand-written kernel
`csrc/propagate.cu` or raises; on a CPU tensor it runs the plain PyTorch
version `propagate_rounds_ref`. There is no other route.

The rounds stay synchronous at every map size: the JAX package sweeps maps
over its VMEM budget in row bands, one band after another, which is not
(ROADMAP.md C); the port has no size gate.
"""

import torch
import torch.nn.functional as F

from .. import _kernels
from .runmax import _check

ROUNDS = 16  # rounds per launch (pallas_propagate.ROUNDS_PER_CALL)

launches = 0  # kernel launches (only where the CUDA kernel is launched)


def propagate_rounds_ref(labels, mask, fill_only):
    """Plain PyTorch version: ROUNDS rounds of four shifted maxima. Returns
    (labels, changed) with changed an int32 (1,) tensor: 1 if round ROUNDS
    changed any pixel."""
    m = mask.bool()
    lbl = labels
    changed = None
    for _ in range(ROUNDS):
        p = F.pad(lbl, (1, 1, 1, 1))  # neighbours outside the map are 0
        best = torch.maximum(
            torch.maximum(lbl, torch.maximum(p[:-2, 1:-1], p[2:, 1:-1])),
            torch.maximum(p[1:-1, :-2], p[1:-1, 2:]),
        )
        if fill_only:
            new = torch.where((lbl == 0) & m, best, lbl)
        else:
            new = torch.where(m, best, 0)
        changed = (new != lbl).any()
        lbl = new
    return lbl.contiguous(), changed.to(torch.int32).reshape(1)


def propagate_rounds(labels, mask, fill_only):
    """ROUNDS synchronous rounds on int32 `labels` (H, W) under `mask` (bool
    or uint8, (H, W)). Returns (labels, changed int32 (1,))."""
    if labels.dim() != 2:
        raise ValueError("labels must be 2-D (H, W), got %s" % (tuple(labels.shape),))
    shape, device = tuple(labels.shape), labels.device
    _check("labels", labels, (torch.int32,), shape, device)
    _check("mask", mask, (torch.bool, torch.uint8), shape, device)
    if device.type == "cpu":
        return propagate_rounds_ref(labels, mask, fill_only)
    if device.type != "cuda":
        raise NotImplementedError("propagate_rounds: no kernel for %s" % device)

    global launches
    fn = _kernels.load("propagate")
    out = torch.empty_like(labels)
    changed = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(labels.data_ptr(), mask.data_ptr(), out.data_ptr(), changed.data_ptr(),
                 shape[0], shape[1], int(bool(fill_only)), stream)
    if err != 0:
        raise RuntimeError("propagate kernel launch failed: cudaError %d" % err)
    launches += 1
    return out, changed


def spread_labels_fixpoint(labels, mask, fill_only=True):
    """Spread labels to the fixpoint: `propagate_rounds` until a launch's
    last round changes nothing. The JAX version is a device while_loop; here
    the flag is read on the host, one `.item()` per launch (as
    cc_label.spread_labels_scan does for K1)."""
    lbl = labels.to(torch.int32).contiguous()
    mask = mask.contiguous()
    while True:
        lbl, changed = propagate_rounds(lbl, mask, fill_only)
        if not changed.item():
            return lbl
