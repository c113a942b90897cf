"""Seeded weights for runs without a trained checkpoint, and the trainer's
initialisation.

`seeded_init_` draws a model's weights from a torch.Generator with the JAX
package's initialisers; tools/train.py starts every training from it
(seeded by Global.seed). Untrained weights map a page to noise and a near
uniform softmax, so `text_like_db_head_`, `text_like_pse_head_`,
`text_like_pan_head_`, `decisive_ctc_head_` and `decisive_cls_head_` reshape
the last layers of the detection, CTC and direction-classifier heads on the
run's own pages: the detection postprocesses then find text-like
components, the CTC collapse reads decided characters and the classifier
decides most crops far from p = 0.5. Used by chip_smoke.py and the slice
test; no serving path calls them.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def seeded_init_(model, generator):
    """Re-initialise `model` in place from a torch.Generator, with the JAX
    package's initialisers: kaiming normal (fan_out) convs, lecun normal
    Linear and LSTM input weights, orthogonal LSTM recurrent weights, zero
    biases, identity BN statistics."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            # fan_out of the flax kernel (kh, kw, in, out) is kh*kw*out
            w = module.weight
            out_ch = w.shape[1] if isinstance(module, nn.ConvTranspose2d) else w.shape[0]
            fan_out = out_ch * w.shape[2] * w.shape[3]
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.mul_((2.0 / fan_out) ** 0.5 / 0.87962566)  # truncated-normal std
        elif isinstance(module, nn.Linear):
            nn.init.trunc_normal_(module.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
            module.weight.mul_((1.0 / module.in_features) ** 0.5 / 0.87962566)
        elif isinstance(module, nn.LSTM):
            for name, w in module.named_parameters():
                if name.startswith("weight_ih"):
                    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                    w.mul_((1.0 / w.shape[1]) ** 0.5 / 0.87962566)
                elif name.startswith("weight_hh"):
                    for g in w.split(module.hidden_size, dim=0):  # per gate
                        nn.init.orthogonal_(g, generator=generator)
            for name, b in module.named_parameters():
                if name.startswith("bias"):
                    b.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                and module.bias is not None:
            module.bias.zero_()
    return model


def _eval_hooked(model, module, images):
    """Run `model` on `images` in eval mode; return `module`'s input."""
    seen = {}

    def keep(mod, inp, out):
        seen["x"] = inp[0]

    hook = module.register_forward_hook(keep)
    was_training = model.training
    model.eval()
    try:
        model(images)
    finally:
        hook.remove()
        model.train(was_training)
    return seen["x"]


@torch.no_grad()
def text_like_db_head_(model, images, dark, thresh=0.3):
    """Make a DB model with untrained, seeded weights map dark text to
    probabilities above `thresh` and the light page below it, so that its
    postprocess finds text-like components instead of noise.

    The binarize tower's two 2x2 deconvs are made phase-free (each tap the
    same, so the map is constant on 4x4 blocks). The last deconv's weights
    become the difference of its input channels' means over the dark and
    the light pixels of `images` (NCHW, normalized; `dark` is (N, H, W) or
    (H, W)), the direction along which dark and light differ most, scaled
    so that the dark pixels' median logit lies 8 above the light pixels'.
    Its bias puts logit(thresh) in the middle of the widest gap between the
    logits on these pages within 1 of the midpoint of the two medians.

    Returns that half gap in logits: the distance of the pixel nearest the
    threshold. A run whose logits differ from this one's by less (another
    device, another summation order) binarizes these pages alike; whether
    it does is for the caller to measure.
    """
    tower = model.head.binarize
    for deconv in (tower.deconv1, tower.deconv2):
        deconv.weight.copy_(deconv.weight.mean(dim=(2, 3), keepdim=True).expand_as(deconv.weight))
    h = _eval_hooked(model, tower.deconv2, images).double().cpu()  # (N, C, H/2, W/2)
    dark = torch.as_tensor(dark, dtype=torch.float64).expand(h.shape[0], -1, -1)
    dark = F.avg_pool2d(dark[:, None], 2)[:, 0]  # share of dark pixels per 2x2 block
    is_dark, is_light = dark > 0.5, dark == 0
    hc = h.permute(1, 0, 2, 3)
    w = hc[:, is_dark].mean(dim=1) - hc[:, is_light].mean(dim=1)
    z = torch.einsum("nchw,c->nhw", h, w)  # the phase-free deconv's logit per block
    zd, zl = z[is_dark].median(), z[is_light].median()
    a = 8.0 / float(zd - zl)
    v = torch.unique(a * (z - (zd + zl) / 2.0))  # 0 = midpoint of the medians
    v = torch.cat([torch.tensor([-1.0], dtype=v.dtype), v[v.abs() < 1.0],
                   torch.tensor([1.0], dtype=v.dtype)])
    widest = int(torch.diff(v).argmax())
    center = float(v[widest] + v[widest + 1]) / 2.0
    weight = (a * w).to(tower.deconv2.weight.dtype)
    tower.deconv2.weight.copy_(weight.view(-1, 1, 1, 1).expand_as(tower.deconv2.weight))
    logit = math.log(thresh / (1.0 - thresh))
    tower.deconv2.bias.fill_(logit - a * float(zd + zl) / 2.0 - center)
    return float(v[widest + 1] - v[widest]) / 2.0


def _text_like_rows_(conv, h, dark, rows, levels, thresh, gain=16.0, window=0.04):
    """Point rows `rows` of the 1x1 conv `conv` along the dark-minus-light
    direction of its input `h` (N, C, H', W'), float64 on the CPU; `dark`
    (N, H, W) marks the dark pixels of the pages, H a multiple of H'.

    u = 0 at the light blocks' median projection and 1 at the dark blocks'
    (a block is dark when half its pixels are). Row k's logit becomes
    thresh + gain * (u - t_k), with t_k in the middle of the widest gap of
    these pages' u within `window` of levels[k]. Returns each row's half gap
    in logits: the distance of its pixel nearest the threshold."""
    n, _, hh, _ = h.shape
    dark = torch.as_tensor(dark, dtype=torch.float64).expand(n, -1, -1)
    share = F.avg_pool2d(dark[:, None], dark.shape[-2] // hh)[:, 0]
    is_dark, is_light = share >= 0.5, share == 0
    hc = h.permute(1, 0, 2, 3)
    w = hc[:, is_dark].mean(dim=1) - hc[:, is_light].mean(dim=1)
    z = torch.einsum("nchw,c->nhw", h, w)
    zd, zl = float(z[is_dark].median()), float(z[is_light].median())
    u = torch.unique((z - zl) / (zd - zl))
    margins = []
    for row, level in zip(rows, levels):
        lo, hi = level - window, level + window
        v = torch.cat([torch.tensor([lo], dtype=u.dtype), u[(u > lo) & (u < hi)],
                       torch.tensor([hi], dtype=u.dtype)])
        widest = int(torch.diff(v).argmax())
        center = float(v[widest] + v[widest + 1]) / 2.0
        conv.weight[row].copy_((gain / (zd - zl) * w).view(-1, 1, 1))
        conv.bias[row] = thresh - gain * (zl / (zd - zl) + center)
        margins.append(gain * float(v[widest + 1] - v[widest]) / 2.0)
    return margins


@torch.no_grad()
def text_like_pse_head_(model, images, dark, thresh=0.0, levels=None):
    """Make a PSE model with untrained, seeded weights map dark text to
    nested kernels: every output map of the head's last 1x1 conv takes the
    same dark-minus-light direction of its input on `images` (NCHW,
    normalized; `dark` (N, H, W) or (H, W)), and the levels rise map by map
    (`levels`, in units of the light-to-dark median distance; default 0.3 to
    0.8), so kernel k+1 lies inside kernel k and the expansion has work at
    every level. The gain puts the text map's logit over dark text near
    +11, far above box_thresh 0.85 (+1.73). Returns each map's margin in
    logits (see _text_like_rows_)."""
    conv = model.head.conv2
    k = conv.out_channels
    if levels is None:
        levels = [0.3 + 0.5 * i / (k - 1) for i in range(k)]
    h = _eval_hooked(model, conv, images).double().cpu()
    return _text_like_rows_(conv, h, dark, range(k), levels, thresh)


@torch.no_grad()
def text_like_pan_head_(model, images, dark, thresh=0.0, levels=(0.3, 0.6)):
    """The PSE helper for a PAN head: maps 0 (text) and 1 (kernel) take the
    dark-minus-light direction at rising levels; the 4 embedding maps keep
    their seeded values. Returns the two maps' margins in logits."""
    conv = model.head.conv2
    h = _eval_hooked(model, conv, images).double().cpu()
    return _text_like_rows_(conv, h, dark, (0, 1), levels, thresh)


@torch.no_grad()
def decisive_ctc_head_(model, images, blank_bias=4.0):
    """Make a CTC recognizer with untrained, seeded weights decide: its
    softmax is otherwise near uniform over thousands of classes, and its
    padded steps tie exactly. The head is scaled so the per-step logits over
    the classes have unit std on `images` (NCHW, normalized), and blank gets
    a bias of `blank_bias`, the prior a trained CTC model learns."""
    fc = model.head.fc
    z = F.linear(_eval_hooked(model, fc, images), fc.weight, fc.bias)
    scale = 1.0 / float(z.float().std(dim=-1).mean())
    fc.weight.mul_(scale)
    fc.bias.mul_(scale)
    fc.bias[0] += blank_bias
    return model


@torch.no_grad()
def decisive_cls_head_(model, images, spread=4.0):
    """Make a direction classifier with untrained, seeded weights decide: its
    two-class softmax is otherwise near 0.5 on every crop. The head's `fc`
    is set so that logit("180") - logit("0") is `spread` times the
    standardised projection of the pooled features of `images` (NCHW,
    normalized; two or more) on their first principal direction, centred in
    the widest gap between the projections of the middle half of the crops:
    about half the crops are labelled "180", most far from p = 0.5.
    Returns the smallest |logit difference| on `images`, the distance of the
    crop nearest a tie."""
    if len(images) < 2:
        raise ValueError("decisive_cls_head_ needs two or more crops")
    fc = model.head.fc
    feats = _eval_hooked(model, fc, images).double().cpu()
    _, _, v = torch.linalg.svd(feats - feats.mean(dim=0), full_matrices=False)
    z = feats @ v[0]
    zs = z.sort().values
    n = len(zs)
    lo, hi = n // 4, max(n // 4 + 1, (3 * n) // 4)
    gap = int(torch.diff(zs[lo : hi + 1]).argmax()) + lo
    med = (zs[gap] + zs[gap + 1]) / 2.0
    a = spread / float((z - med).std())
    fc.weight.zero_()
    fc.bias.zero_()
    fc.weight[1] = (a * v[0]).to(fc.weight.dtype)
    fc.bias[1] = -a * float(med)
    return float((a * (z - med)).abs().min())
