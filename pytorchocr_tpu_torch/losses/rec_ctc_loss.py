"""CTC loss — port of pytorchocr_tpu/losses/rec_ctc_loss.py:11-36.

The JAX loss is `optax.ctc_loss` over batch-major (N, T, C) logits (it
applies log_softmax itself), blank 0; each sequence's loss is divided by
max(length, 1), then the batch mean is taken. The port computes each row
whose label fits in T frames with `F.ctc_loss`, which takes time-major
log-probabilities.

Where a label cannot fit (its length plus its adjacent repeats exceeds T)
the two differ: `F.ctc_loss` gives inf, and inf gives NaN gradients, while
optax works in log space with log(0) taken as `log_epsilon = -1e5` and
gives a finite value near 1e5. The port follows the JAX package: such rows
go through `optax_ctc_forward`, a plain copy of optax's alpha recursion, and
autograd gives optax's gradient there. `zero_infinity` changes nothing, as
in JAX, where the optax value is never infinite. Finding those rows reads
one flag from the card each step (a host sync). No shipped config reaches
the recursion: T = 80 at width 320, and 25 characters need at most 49
frames.

On CUDA, PyTorch documents F.ctc_loss's backward as nondeterministic, so
two runs of one step may differ in the last bits of the logits' gradient
(chip_smoke.py's bit-for-bit checkpoint round trip takes a batch of 8,
where two runs agreed).
"""

import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5  # optax.ctc_loss's approximation of log(0)


def ctc_infeasible(labels, lengths, t):
    """Rows whose label needs more than `t` frames: its length plus the
    adjacent repeats within it (each repeat needs a blank between)."""
    pos = torch.arange(1, labels.shape[1], device=labels.device)
    repeats = (labels[:, 1:] == labels[:, :-1]) & (pos[None, :] < lengths[:, None])
    return lengths + repeats.sum(1) > t


def optax_ctc_forward(logits, labels, lengths, log_epsilon=LOG_EPSILON):
    """The per-sequence loss of `optax.ctc_loss_with_forward_probs` (no
    padded frames; labels right-padded past `lengths`), step for step: the
    blank ("phi") and label ("emit") alphas in log space, log(0) taken as
    `log_epsilon`. A plain PyTorch loop over T; autograd gives optax's
    gradient."""
    n, t, _ = logits.shape
    s = labels.shape[1]
    logprobs = F.log_softmax(logits, dim=2)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype), (0, 1))
    logprobs_phi = logprobs[:, :, 0:1]  # (N, T, 1)
    logprobs_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(n, t, s))  # (N, T, S)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)

    phi = torch.full((n, s + 1), log_epsilon, dtype=logits.dtype, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((n, s), log_epsilon, dtype=logits.dtype, device=logits.device)
    for step in range(t):
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi = logprobs_emit[:, step], logprobs_phi[:, step]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    last = update_phi(phi, emit)
    return -last.gather(1, lengths[:, None]).squeeze(1)


class CTCLoss:
    def __init__(self, zero_infinity=False, **kwargs):
        self.zero_infinity = zero_infinity  # a no-op, as in JAX (module docstring)

    def __call__(self, predicts, batch):
        if isinstance(predicts, (list, tuple)):
            predicts = predicts[-1]
        # (N, T, C) in float32, as JAX casts them; float64 stays (the card's
        # float32 step is held to a float64 one)
        logits = predicts if predicts.dtype == torch.float64 else predicts.float()
        n, t, _ = logits.shape
        labels = batch[1].long()  # (N, max_text_len), 0-padded
        lengths = batch[2].long()  # (N,)
        log_probs = F.log_softmax(logits, dim=2).transpose(0, 1)  # (T, N, C)
        frames = torch.full((n,), t, dtype=torch.long, device=logits.device)
        # rows that cannot fit come out 0 with a zero gradient here, and are
        # replaced below (F.ctc_loss's inf would give NaN gradients)
        per_seq = F.ctc_loss(log_probs, labels, frames, lengths, blank=0, reduction="none",
                             zero_infinity=True)
        infeasible = ctc_infeasible(labels, lengths, t)
        if bool(infeasible.any()):
            rows = infeasible.nonzero().squeeze(1)
            per_seq = per_seq.index_put((rows,), optax_ctc_forward(logits[rows], labels[rows],
                                                                   lengths[rows]))
        loss = (per_seq / lengths.clamp(min=1).to(per_seq.dtype)).mean()
        return {"loss": loss}
