"""SLANet's table head — port of pytorchocr_tpu/modeling/heads/table_att_head.py.

The JAX head runs its `max_text_length + 1` decode steps as one `nn.scan`
(:171-187); here they are a Python loop over the same step, every step
run (no stop at eos, as the scan has none). `i2h`, the projection of the
feature map, is computed once before the loop (:115-118). A step (:28-88):
attention over the H*W positions (`h2h`, `score`, a float32 softmax), the
context, its concat with the one-hot of the fed token, the recurrent cell,
then `structure_fc1/2` (logits, float32) and `loc_fc1/2` with a sigmoid.

Fed tokens: eval feeds back each step's greedy argmax. Train with targets
feeds the teacher's `targets[1][:, :steps]`; with scheduled sampling (p >
0) a step feeds the previous step's own argmax where its coin is 1. The
JAX coins come from `fold_in(PRNGKey(17), step)`, split per scan step
(trainer.py:159), a stream torch cannot reproduce: here the train step
hands the forward a torch.Generator on the model's device seeded from (17,
step) (trainer.sample_generator), and the (N, steps) coins are drawn from it
once a forward. Across ranks (parallel/mesh.py) each rank draws the coins
of the global batch, (N x data world, steps), and keeps its own rows, so N
ranks feed what one rank feeds the global batch. A forward without a generator, and eval, feed as p = 0
does, as the JAX head does without a "sample" rng. Softmax is applied at
eval only.

A step is ~20 kernel launches at eval: every weight it reads is cast to the
compute dtype once a forward (`_DecodeStep.weights`), the GRU's six Linears
run as two matmuls, structure_fc1 and loc_fc1 as one, and the logits' cast
to float32 and the locs' sigmoid run once after the loop.

The cells carry flax's parameters, not nn.GRUCell's / nn.LSTMCell's: the
GRU has `ir`, `iz`, `in` with biases and `hr`, `hz` without, `hn` with one
(flax GRUCell); the LSTM has `ii`, `if`, `ig`, `io` without biases and
`hi`, `hf`, `hg`, `ho` with (flax OptimizedLSTMCell). nn.GRUCell's extra
`b_hr`, `b_hz` would get the same gradient as `b_ir`, `b_iz`, and Adam
would move their sums twice as far. Every module is a Linear named as its
flax Dense, so the weight bridge's Linear rule maps them. Module paths
mirror the flax tree: `head/i2h`, `head/decode/{h2h, score, rnn/..,
structure_fc1, ...}`, and with `aux_count` `head/{count_pool, count_fc,
row_head, col_head, init_state}`.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import data_shard

__all__ = ["SLAHead", "GRUCell", "LSTMCell"]


class GRUCell(nn.Module):
    """flax GRUCell: r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)), h' = (1 - z) n + z h; returns (h', h')."""

    def __init__(self, in_features, hidden):
        super().__init__()
        for g in ("r", "z", "n"):
            self.add_module("i" + g, nn.Linear(in_features, hidden))
            self.add_module("h" + g, nn.Linear(hidden, hidden, bias=g == "n"))

    def weights(self, dtype):
        """The six Linears as two matmuls' operands in `dtype`, built once a
        forward: [ir; iz; in] with their biases and [hr; hz; hn] with (0, 0,
        hn's bias)."""
        m = self._modules
        w_i = torch.cat([m[g].weight for g in ("ir", "iz", "in")])
        b_i = torch.cat([m[g].bias for g in ("ir", "iz", "in")])
        b_hn = m["hn"].bias
        w_h = torch.cat([m[g].weight for g in ("hr", "hz", "hn")])
        b_h = torch.cat([b_hn.new_zeros(2 * b_hn.shape[0]), b_hn])
        return tuple(t.to(dtype) for t in (w_i, b_i, w_h, b_h))

    def forward(self, h, x, w):
        """One step with `w` = weights(...); (1 - z) n + z h as n + z (h - n)
        (lerp)."""
        w_i, b_i, w_h, b_h = w
        gi, gh = F.linear(x, w_i, b_i), F.linear(h, w_h, b_h)
        k = h.shape[1]
        rz = torch.sigmoid(gi[:, : 2 * k] + gh[:, : 2 * k])
        n = torch.tanh(torch.addcmul(gi[:, 2 * k :], rz[:, :k], gh[:, 2 * k :]))
        new_h = torch.lerp(n, h, rz[:, k:])
        return new_h, new_h

    def recurrent_weights(self):
        """The kernels flax initialises orthogonal (utils/seeded.py)."""
        return [self._modules[g].weight for g in ("hr", "hz", "hn")]


class LSTMCell(nn.Module):
    """flax OptimizedLSTMCell: gates i, f, o = sigmoid, g = tanh of
    i*(x) + h*(h); c' = f c + i g, h' = o tanh(c'); the carry is (c, h) and
    the output h'."""

    def __init__(self, in_features, hidden):
        super().__init__()
        for g in ("i", "f", "g", "o"):
            self.add_module("i" + g, nn.Linear(in_features, hidden, bias=False))
            self.add_module("h" + g, nn.Linear(hidden, hidden))

    def weights(self, dtype):
        return None

    def forward(self, carry, x, w=None):
        c, h = carry
        m = self._modules
        i = torch.sigmoid(m["ii"](x) + m["hi"](h))
        f = torch.sigmoid(m["if"](x) + m["hf"](h))
        g = torch.tanh(m["ig"](x) + m["hg"](h))
        o = torch.sigmoid(m["io"](x) + m["ho"](h))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h

    def recurrent_weights(self):
        return [self._modules[g].weight for g in ("hi", "hf", "hg", "ho")]


class _DecodeStep(nn.Module):
    """One decode step's modules (the flax `decode` scope)."""

    def __init__(self, in_channels, hidden, num_embeddings, loc_reg_num, use_gru):
        super().__init__()
        self.use_gru = use_gru
        self.h2h = nn.Linear(hidden, hidden, bias=False)
        self.score = nn.Linear(hidden, 1, bias=False)
        cell = GRUCell if use_gru else LSTMCell
        self.rnn = cell(in_channels + num_embeddings, hidden)
        self.structure_fc1 = nn.Linear(hidden, hidden)
        self.structure_fc2 = nn.Linear(hidden, num_embeddings)
        self.loc_fc1 = nn.Linear(hidden, hidden)
        self.loc_fc2 = nn.Linear(hidden, loc_reg_num)

    def weights(self, dtype):
        """Every weight a step reads, in the compute dtype, built once a
        forward: autocast would cast each again at every step (and under
        inference_mode it keeps no cast), and structure_fc1 and loc_fc1, which
        read the same input, as one matmul."""
        c = lambda t: t.to(dtype)  # noqa: E731
        return dict(
            h2h=c(self.h2h.weight), score=c(self.score.weight),
            fc1_w=c(torch.cat([self.structure_fc1.weight, self.loc_fc1.weight])),
            fc1_b=c(torch.cat([self.structure_fc1.bias, self.loc_fc1.bias])),
            fc2_w=c(self.structure_fc2.weight), fc2_b=c(self.structure_fc2.bias),
            loc2_w=c(self.loc_fc2.weight), loc2_b=c(self.loc_fc2.bias),
            rnn=self.rnn.weights(dtype))

    def forward(self, state, onehot, feats, feats_proj, w):
        """One step with `w` = weights(...): the new state, the structure
        logits and the loc pre-activations in the compute dtype (the head
        casts them to float32, and takes the locs' sigmoid, after the loop)."""
        hidden = state if self.use_gru else state[1]
        prev_proj = F.linear(hidden, w["h2h"])[:, None, :]
        e = F.linear(torch.tanh(feats_proj + prev_proj), w["score"])  # (N, HW, 1)
        alpha = torch.softmax(e.float(), dim=1).to(feats.dtype)
        context = torch.bmm(alpha.transpose(1, 2), feats)[:, 0]  # (N, C)
        new_state, output = self.rnn(state, torch.cat([context, onehot], 1), w["rnn"])
        k = output.shape[1]
        sl = F.linear(output, w["fc1_w"], w["fc1_b"])
        structure = F.linear(sl[:, :k], w["fc2_w"], w["fc2_b"])
        loc = F.linear(sl[:, k:], w["loc2_w"], w["loc2_b"])
        return new_state, structure, loc


class SLAHead(nn.Module):
    """`forward(x, targets=None, generator=None)`: x (N, C, H, W); returns
    {"structure_probs": (N, steps, out_channels) logits at train and
    probabilities at eval, "loc_preds": (N, steps, loc_reg_num)}, with
    `aux_count` also "row_logits" and "col_logits" (N, max_count)."""

    takes_generator = True  # BaseModel hands it the train step's generator

    def __init__(self, in_channels, hidden_size, out_channels=30, max_text_length=500,
                 loc_reg_num=4, use_gru=True, scheduled_sampling_p=0.0, aux_count=False,
                 max_count=32):
        super().__init__()
        self.hidden_size = hidden_size
        self.out_channels = out_channels
        self.max_text_length = max_text_length
        self.use_gru = use_gru
        self.scheduled_sampling_p = float(scheduled_sampling_p)
        self.aux_count = aux_count
        self.i2h = nn.Linear(in_channels, hidden_size, bias=False)
        if aux_count:
            self.count_pool = nn.Linear(hidden_size, 2, bias=False)
            self.count_fc = nn.Linear(2 * in_channels, hidden_size)
            self.row_head = nn.Linear(hidden_size, max_count)
            self.col_head = nn.Linear(hidden_size, max_count)
            self.init_state = nn.Linear(hidden_size, hidden_size)
        self.decode = _DecodeStep(in_channels, hidden_size, out_channels, loc_reg_num,
                                  use_gru)

    def forward(self, x, targets=None, generator=None):
        n = x.shape[0]
        feats = x.flatten(2).transpose(1, 2)  # (N, HW, C)
        feats_proj = self.i2h(feats)
        steps = self.max_text_length + 1
        teacher = self.training and targets is not None
        out = {}
        if self.aux_count:
            pool_a = torch.softmax(self.count_pool(torch.tanh(feats_proj)).float(), dim=1)
            pooled = torch.bmm(pool_a.to(feats.dtype).transpose(1, 2), feats).reshape(n, -1)
            ch = torch.relu(self.count_fc(pooled))
            out["row_logits"] = self.row_head(ch).float()
            out["col_logits"] = self.col_head(ch).float()
            init_h = torch.tanh(self.init_state(ch))
            state = init_h if self.use_gru else (init_h, init_h)
        else:
            zeros = feats_proj.new_zeros((n, self.hidden_size))
            state = zeros if self.use_gru else (zeros, zeros)

        eye = torch.eye(self.out_channels, dtype=feats_proj.dtype, device=x.device)
        w = self.decode.weights(feats_proj.dtype)
        tokens = coins = None
        if teacher:
            tokens = targets[1][:, :steps].long()
            if self.scheduled_sampling_p > 0.0 and generator is not None:
                shard, shards = data_shard()
                coins = torch.rand((n * shards, steps), generator=generator,
                                   device=generator.device)[shard * n:(shard + 1) * n]
                coins = coins < self.scheduled_sampling_p
        own = teacher and coins is not None
        prev = torch.zeros((n,), dtype=torch.long, device=x.device)
        structures, locs = [], []
        for t in range(steps):
            if own:
                char = torch.where(coins[:, t], prev, tokens[:, t])
            elif teacher:
                char = tokens[:, t]
            else:
                char = prev
            state, structure, loc = self.decode(state, eye[char], feats, feats_proj, w)
            structures.append(structure)
            locs.append(loc)
            if own or not teacher:
                prev = torch.argmax(structure, dim=1)
        structure_preds = torch.stack(structures, 1).float()
        if not self.training:
            structure_preds = torch.softmax(structure_preds, dim=-1)
        out["structure_probs"] = structure_preds
        out["loc_preds"] = torch.sigmoid(torch.stack(locs, 1).float())
        return out
