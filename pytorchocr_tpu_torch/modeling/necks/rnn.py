"""Sequence encoder neck — port of pytorchocr_tpu/modeling/necks/rnn.py.

Sequences are batch-major (N, T, C), as in the JAX package. The BiLSTM is
`nn.LSTM(bidirectional=True)` over the whole padded sequence (not packed:
the JAX backward direction also runs over the flipped padded sequence). The
`lstm0` projection is a Linear named `embedding` applied after the
concatenation of both directions, not nn.LSTM's proj_size (which projects
inside the recurrence).

The LSTM always runs in float32, autocast off. The JAX cell runs its
matmuls in bf16 under bf16 compute and keeps an f32 carry; the port keeps
the whole recurrence in float32 (a recorded difference, ROADMAP.md C), and
the recurrence is a small share of the recognizer's time.

The JAX BiLSTM has one bias per direction, `b (2, 4H)`; nn.LSTM has two,
`bias_ih` and `bias_hh`, which enter the gates as their sum. `bias_ih`
stands for `b`; `bias_hh` is held at zero and takes no gradient
(requires_grad False), so the optimizer never sees it: trained as a second
copy of `b` it would get the same gradient and Adam would move the sum by
twice the JAX step. It stays in the state_dict, so `.pt` files and
checkpoints keep their keys.
"""

import torch
from torch import nn

__all__ = ["SequenceEncoder", "Im2Seq", "BiLSTM"]


class Im2Seq(nn.Module):
    """(N, C, 1, W) -> (N, T=W, C)."""

    def forward(self, x):
        if x.shape[2] != 1:
            raise ValueError("the height of backbone output featuremap must be 1")
        return x[:, :, 0, :].permute(0, 2, 1)


class BiLSTM(nn.Module):
    """Bidirectional LSTM (gates i, f, g, o; zero initial state), optionally
    followed by a Linear projection of the concatenated directions."""

    def __init__(self, in_channels, hidden_size, proj_size=0):
        super().__init__()
        self.rnn = nn.LSTM(in_channels, hidden_size, batch_first=True,
                           bidirectional=True)
        for name, b in self.rnn.named_parameters():
            if name.startswith("bias_hh"):
                nn.init.zeros_(b)
                b.requires_grad_(False)
        self.embedding = nn.Linear(2 * hidden_size, proj_size) if proj_size else None

    def forward(self, x):
        with torch.autocast(device_type=x.device.type, enabled=False):
            y, _ = self.rnn(x.to(self.rnn.weight_ih_l0.dtype))
        if self.embedding is not None:
            y = self.embedding(y)
        return y


class EncoderWithRNN(nn.Module):
    """Two stacked BiLSTMs, the first projected back to hidden_size;
    out_channels = 2 * hidden_size."""

    def __init__(self, in_channels, hidden_size):
        super().__init__()
        self.lstm0 = BiLSTM(in_channels, hidden_size, hidden_size)
        self.lstm1 = BiLSTM(hidden_size, hidden_size, 0)

    def forward(self, x):
        return self.lstm1(self.lstm0(x))


class EncoderWithFC(nn.Module):
    def __init__(self, in_channels, hidden_size):
        super().__init__()
        self.fc = nn.Linear(in_channels, hidden_size)

    def forward(self, x):
        return self.fc(x)


class SequenceEncoder(nn.Module):
    """Im2Seq + {reshape|fc|rnn} encoder."""

    def __init__(self, in_channels, encoder_type="rnn", hidden_size=256):
        super().__init__()
        self.encoder_type = encoder_type
        self.encoder_reshape = Im2Seq()
        if encoder_type == "reshape":
            self.encoder = None
            self.out_channels = in_channels
        elif encoder_type == "fc":
            self.encoder = EncoderWithFC(in_channels, hidden_size)
            self.out_channels = hidden_size
        elif encoder_type == "rnn":
            self.encoder = EncoderWithRNN(in_channels, hidden_size)
            self.out_channels = hidden_size * 2
        else:
            raise ValueError("encoder_type must be in [reshape, fc, rnn]")

    def forward(self, x):
        x = self.encoder_reshape(x)
        return x if self.encoder is None else self.encoder(x)
