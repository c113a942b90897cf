"""Data op registry — the port's copy of pytorchocr_tpu/data/imaug/__init__.py
(`transform`, `create_operators`), one module per JAX module of
pytorchocr_tpu/data/imaug/.

Ported: the eval ops of the deploy entry points, the DB, PSE and PAN training
chains (det_r18_db*.yml, det_r50_pse*.yml, det_r18_pan*.yml), and the CRNN
and cls training chains (rec_vgg_bilstm_ctc*.yml, cls_mbv3small*.yml). Any
other op of the
JAX registry raises NotImplementedError naming the ROADMAP.md item that
ports it.
"""

from .color_jitter import ColorJitter
from .fused_aug_crop import FusedDetAugCrop
from .iaa_augment import IaaAugment
from .label_ops import ClsLabelEncode, CTCLabelEncode, DetLabelEncode
from .make_border_map import MakeBorderMap
from .make_pan_gt import MakePanGt
from .make_pse_gt import MakePseGt
from .make_shrink_map import MakeShrinkMap
from .operators import (DecodeImage, DetResizeForTest, KeepKeys, Normalize, NormalizeImage,
                        ToTensor)
from .random_crop_data import EastRandomCropData, RandomCropImgMask
from .randaugment import RandAugment
from .rec_img_aug import ClsResizeImg, RecAug, RecResizeImg

OPS = {op.__name__: op for op in (
    DecodeImage, ToTensor, Normalize, NormalizeImage, KeepKeys, DetResizeForTest,
    RecResizeImg, ClsResizeImg, DetLabelEncode, IaaAugment, EastRandomCropData,
    FusedDetAugCrop, MakeShrinkMap, MakeBorderMap, ClsLabelEncode, CTCLabelEncode, RecAug,
    RandAugment, ColorJitter, MakePseGt, MakePanGt, RandomCropImgMask,
)}

_LATER = dict(
    # training ops that no config of the repo uses
    {name: "A.15" for name in ("CopyPaste", "Resize", "ToCHWImage")},
    AttnLabelEncode="A.11",
    RecResizeImgForTest="A.6", TableLabelEncode="A.13",
    TableBoxEncode="A.13", ResizeTableImage="A.13", PaddingTableImage="A.13",
)


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
