"""CTC label decode — port of pytorchocr_tpu/postprocess/rec_postprocess.py.

The greedy collapse runs on the tensor's device (ops/ctc_decode.py); only
(codes, lengths, conf) cross to the host, where the JAX package's character
table maps codes to text. The JAX class is used for its table and its host
`decode` only: its `__call__` picks a jax path for anything with a `device`
attribute. Not ported: AttnLabelDecode (ROADMAP.md A.11) and
DistillationCTCLabelDecode (A.12).
"""

import numpy as np
import torch

from pytorchocr_tpu.postprocess.rec_postprocess import CTCLabelDecode as _Table

from ..ops.ctc_decode import ctc_greedy_collapse


class CTCLabelDecode:
    def __init__(self, character_dict_path=None, use_space_char=False, **kwargs):
        self._table = _Table(character_dict_path, use_space_char)
        self.character = self._table.character

    def __call__(self, preds, label=None, *args, **kwargs):
        if isinstance(preds, (list, tuple)):
            preds = preds[-1]
        if not torch.is_tensor(preds):
            preds = torch.from_numpy(np.asarray(preds))
        max_len = min(int(preds.shape[1]), 128)
        codes, lengths, conf = ctc_greedy_collapse(preds, max_len=max_len)
        codes, lengths, conf = codes.cpu().numpy(), lengths.cpu().numpy(), conf.cpu().numpy()
        text = [
            ("".join(self.character[c] for c in codes[i, : lengths[i]]), float(conf[i]))
            for i in range(codes.shape[0])
        ]
        if label is None:
            return text
        return text, self._table.decode(np.asarray(label))
