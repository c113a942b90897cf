"""Eval-time preprocessing ops — the port's copy of the registry contract of
pytorchocr_tpu/data/imaug/__init__.py:47-72 (`transform`, `create_operators`),
so that the port imports nothing of the JAX package.

Only the ops that the deploy entry points run are ported: after
`Deter`/`Recer`/`Clser` drop DecodeImage, the label encoders, ToTensor and
Normalize, the det configs keep DetResizeForTest and KeepKeys, the rec config
RecResizeImg and KeepKeys, the cls config ClsResizeImg and KeepKeys
(`imaug.py`). Any other op of the JAX registry
raises NotImplementedError naming the ROADMAP.md item that ports it.
"""

from .imaug import ClsResizeImg, DetResizeForTest, KeepKeys, RecResizeImg

OPS = {"DetResizeForTest": DetResizeForTest, "KeepKeys": KeepKeys,
       "RecResizeImg": RecResizeImg, "ClsResizeImg": ClsResizeImg}

_LATER = dict(
    {name: "A.7" for name in (
        "DecodeImage", "Normalize", "NormalizeImage", "Resize", "ToCHWImage", "ToTensor",
        "AttnLabelEncode", "ClsLabelEncode", "CTCLabelEncode", "DetLabelEncode", "RecAug",
        "RandAugment", "IaaAugment", "FusedDetAugCrop", "EastRandomCropData",
        "RandomCropImgMask", "MakeShrinkMap", "MakeBorderMap", "MakePseGt", "MakePanGt",
        "CopyPaste", "ColorJitter",
    )},
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
