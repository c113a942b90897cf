"""Data op registry — the port's copy of pytorchocr_tpu/data/imaug/__init__.py
(`transform`, `create_operators`), one module per JAX module of
pytorchocr_tpu/data/imaug/.

Ported: every op of the JAX registry but RecResizeImgForTest (the JAX
package's width-bucketed batching resize, rec_img_aug.py:60, a TPU
compile-shape workaround that no config or CLI calls), which raises
NotImplementedError naming ROADMAP.md A.15.
"""

from .color_jitter import ColorJitter
from .copy_paste import CopyPaste
from .fused_aug_crop import FusedDetAugCrop
from .iaa_augment import IaaAugment
from .label_ops import (AttnLabelEncode, ClsLabelEncode, CTCLabelEncode, DetLabelEncode,
                        TableBoxEncode, TableLabelEncode)
from .make_border_map import MakeBorderMap
from .make_pan_gt import MakePanGt
from .make_pse_gt import MakePseGt
from .make_shrink_map import MakeShrinkMap
from .operators import (DecodeImage, DetResizeForTest, KeepKeys, Normalize, NormalizeImage,
                        Resize, ToCHWImage, ToTensor)
from .random_crop_data import EastRandomCropData, RandomCropImgMask
from .randaugment import RandAugment
from .rec_img_aug import ClsResizeImg, RecAug, RecResizeImg
from .table_ops import PaddingTableImage, ResizeTableImage

OPS = {op.__name__: op for op in (
    DecodeImage, ToTensor, Normalize, NormalizeImage, KeepKeys, DetResizeForTest,
    RecResizeImg, ClsResizeImg, DetLabelEncode, IaaAugment, EastRandomCropData,
    FusedDetAugCrop, MakeShrinkMap, MakeBorderMap, ClsLabelEncode, CTCLabelEncode, RecAug,
    RandAugment, ColorJitter, MakePseGt, MakePanGt, RandomCropImgMask, TableLabelEncode,
    TableBoxEncode, ResizeTableImage, PaddingTableImage, AttnLabelEncode, CopyPaste, Resize,
    ToCHWImage,
)}

_LATER = {"RecResizeImgForTest": "A.15"}


def transform(data, ops=None):
    """Run the op chain over a data dict; None aborts the sample. From
    data/imaug/__init__.py:47."""
    for op in ops or []:
        data = op(data)
        if data is None:
            return None
    return data


def create_operators(op_param_list, global_config=None):
    """Build operators from the config list of {OpName: {params}} dicts, the
    `Global` section merged into every op's kwargs. From
    data/imaug/__init__.py:58."""
    if not isinstance(op_param_list, list):
        raise TypeError("operator config should be a list")
    ops = []
    for operator in op_param_list:
        if not (isinstance(operator, dict) and len(operator) == 1):
            raise ValueError("yaml format error in transforms: %s" % operator)
        op_name = list(operator)[0]
        if op_name not in OPS:
            if op_name in _LATER:
                raise NotImplementedError("data op %s is not ported yet (ROADMAP.md %s)"
                                          % (op_name, _LATER[op_name]))
            raise NotImplementedError("data op %s: unknown; the port supports %s"
                                      % (op_name, list(OPS)))
        param = {} if operator[op_name] is None else dict(operator[op_name])
        if global_config is not None:
            param.update(global_config)
        ops.append(OPS[op_name](**param))
    return ops
