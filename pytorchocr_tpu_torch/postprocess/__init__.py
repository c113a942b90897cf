"""Postprocess registry — port of pytorchocr_tpu/postprocess/__init__.py."""

import copy

__all__ = ["build_post_process"]


def build_post_process(config, global_config=None):
    from .cls_postprocess import ClsPostProcess
    from .db_postprocess import DBPostProcess, DistillationDBPostProcess
    from .pan_postprocess import PANPostProcess
    from .pse_postprocess import PSEPostProcess
    from .rec_postprocess import AttnLabelDecode, CTCLabelDecode, DistillationCTCLabelDecode
    from .table_postprocess import TableLabelDecode

    support = {"DBPostProcess": DBPostProcess, "PSEPostProcess": PSEPostProcess,
               "PANPostProcess": PANPostProcess, "CTCLabelDecode": CTCLabelDecode,
               "ClsPostProcess": ClsPostProcess, "TableLabelDecode": TableLabelDecode,
               "DistillationDBPostProcess": DistillationDBPostProcess,
               "DistillationCTCLabelDecode": DistillationCTCLabelDecode,
               "AttnLabelDecode": AttnLabelDecode}
    config = copy.deepcopy(config)
    name = config.pop("name")
    if name == "None":
        return None
    if global_config is not None:
        config.update(global_config)
    if name in support:
        return support[name](**config)
    raise NotImplementedError("post process %s: unknown; the port supports %s"
                              % (name, list(support)))
