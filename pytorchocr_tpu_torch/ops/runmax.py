"""Segmented run-max scan (K1) — port of
pytorchocr_tpu/ops/pallas_propagate.py:segmented_runmax_pallas.

Along `axis` of an int32 (H, W) map, every pixel of a maximal contiguous
masked run gets max(0, max of the run); unmasked pixels get 0. For the
non-negative labels of connected-component labelling this is exactly the
run's max, as in the JAX oracle `cc_label._segmented_runmax`.

On a CUDA tensor `segmented_runmax` launches the hand-written kernel
`csrc/runmax.cu` or raises; on a CPU tensor it runs the plain PyTorch version
`segmented_runmax_ref`. There is no other route.
"""

import torch

from .. import _kernels

launches = 0  # kernel launches (only where the CUDA kernel is launched)

# rows of one block of the axis-0 kernel (csrc/runmax.cu: kMaxSegs * kSegRows);
# taller maps need a scratch buffer for the blocks' run summaries
BLOCK_ROWS = 2048


def segmented_runmax_ref(vals, mask, axis):
    """Plain PyTorch version: each run gets an id (a cumsum over run starts),
    then one scatter amax per run and a gather back."""
    m = mask.bool()
    v = torch.where(m, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    if axis == 0:
        m, v = m.t(), v.t()
    h, w = m.shape
    before = torch.zeros((h, 1), dtype=torch.bool, device=m.device)
    start = m & ~torch.cat([before, m[:, :-1]], dim=1)  # runs never span lines
    rid = torch.cumsum(start.reshape(-1), 0) * m.reshape(-1)  # 0 = unmasked
    best = torch.zeros(h * w + 1, dtype=vals.dtype, device=vals.device)
    best.scatter_reduce_(0, rid, v.reshape(-1), "amax", include_self=True)
    out = torch.where(m.reshape(-1), best[rid], 0).reshape(h, w)
    if axis == 0:
        out = out.t()
    return out.contiguous()


def _check(name, t, dtypes, shape, device):
    if t.dtype not in dtypes:
        raise TypeError("%s: dtype %s not in %s" % (name, t.dtype, dtypes))
    if tuple(t.shape) != shape:
        raise ValueError("%s: shape %s, expected %s" % (name, tuple(t.shape), shape))
    if t.device != device:
        raise ValueError("%s: on %s, expected %s" % (name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("%s: must be contiguous" % name)


def segmented_runmax(vals, mask, axis, prev=None):
    """Per-run max along `axis` of int32 `vals` (H, W) under `mask` (bool or
    uint8, (H, W)).

    With `prev` (int32, (H, W); axis 0 only) it also returns an int32 (1,)
    tensor that is 1 if any output differs from `prev`: the changed flag of
    the fixpoint loop, fused into the same launch on the card.
    """
    if vals.dim() != 2:
        raise ValueError("vals must be 2-D (H, W), got %s" % (tuple(vals.shape),))
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    shape, device = tuple(vals.shape), vals.device
    _check("vals", vals, (torch.int32,), shape, device)
    _check("mask", mask, (torch.bool, torch.uint8), shape, device)
    if prev is not None:
        if axis != 0:
            raise ValueError("the changed flag (prev) is fused into the axis-0 pass only")
        _check("prev", prev, (torch.int32,), shape, device)

    if device.type == "cpu":
        out = segmented_runmax_ref(vals, mask, axis)
        if prev is None:
            return out
        return out, (out != prev).any().to(torch.int32).reshape(1)
    if device.type != "cuda":
        raise NotImplementedError("segmented_runmax: no kernel for %s" % device)

    out = torch.empty_like(vals)
    changed = None if prev is None else torch.empty(1, dtype=torch.int32, device=device)
    scratch = None
    if axis == 0 and shape[0] > BLOCK_ROWS:
        scratch = torch.empty(3 * -(-shape[0] // BLOCK_ROWS) * shape[1], dtype=torch.int32,
                              device=device)
    launch(vals, mask, out, axis, prev, changed, scratch)
    return out if prev is None else (out, changed)


def launch(vals, mask, out, axis, prev=None, changed=None, scratch=None):
    """One launch of the kernel into `out` (and `changed`, which the kernel
    zeroes first), on CUDA tensors that `segmented_runmax` has checked and
    allocated: no checks, no allocation."""
    global launches
    fn = _kernels.load("runmax")
    err = _kernels.call(
        fn, vals.device, vals.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if prev is None else prev.data_ptr(),
        None if changed is None else changed.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel(),
        vals.shape[0], vals.shape[1], axis,
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("runmax kernel launch failed: cudaError %d" % err)
    launches += 1
