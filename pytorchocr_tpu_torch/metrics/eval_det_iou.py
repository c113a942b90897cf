"""ICDAR-2015 detection IoU evaluator (the MhLiao/DB protocol) — the port's
copy of pytorchocr_tpu/metrics/eval_det_iou.py:13. Polygon intersection, IoU
and validity come from the port's utils/geometry.py; the IoU matrix from the
port's native library where the polygons have one arity (:76-95), else the
numpy `poly_iou`.
"""

import numpy as np

from .. import native
from ..utils import geometry


class DetectionIoUEvaluator:
    def __init__(self, iou_constraint=0.5, area_precision_constraint=0.5):
        self.iou_constraint = iou_constraint
        self.area_precision_constraint = area_precision_constraint

    def evaluate_image(self, gt, pred):
        gtPols = []
        gtDontCarePolsNum = []
        for n in range(len(gt)):
            points = np.asarray(gt[n]["points"], dtype=np.float64)
            if not geometry.is_valid_simple_polygon(points):
                continue
            gtPols.append(points)
            if gt[n]["ignore"]:
                gtDontCarePolsNum.append(len(gtPols) - 1)

        detPols = []
        detDontCarePolsNum = []
        for n in range(len(pred)):
            points = np.asarray(pred[n]["points"], dtype=np.float64)
            if not geometry.is_valid_simple_polygon(points):
                continue
            detPols.append(points)
            if gtDontCarePolsNum:
                for dontCarePol in gtDontCarePolsNum:
                    dc = gtPols[dontCarePol]
                    intersected_area = geometry.poly_intersection_area(dc, points)
                    pdDimensions = abs(geometry.polygon_area(points))
                    precision = (
                        0 if pdDimensions == 0 else intersected_area / pdDimensions
                    )
                    if precision > self.area_precision_constraint:
                        detDontCarePolsNum.append(len(detPols) - 1)
                        break

        detMatched = 0
        if gtPols and detPols:
            gtRectMat = np.zeros(len(gtPols), np.int8)
            detRectMat = np.zeros(len(detPols), np.int8)
            iouMat = self._iou_matrix(gtPols, detPols)
            for gtNum in range(len(gtPols)):
                for detNum in range(len(detPols)):
                    if (
                        gtRectMat[gtNum] == 0
                        and detRectMat[detNum] == 0
                        and gtNum not in gtDontCarePolsNum
                        and detNum not in detDontCarePolsNum
                    ):
                        if iouMat[gtNum, detNum] > self.iou_constraint:
                            gtRectMat[gtNum] = 1
                            detRectMat[detNum] = 1
                            detMatched += 1

        numGtCare = len(gtPols) - len(gtDontCarePolsNum)
        numDetCare = len(detPols) - len(detDontCarePolsNum)
        return {
            "gtCare": numGtCare,
            "detCare": numDetCare,
            "detMatched": detMatched,
        }

    @staticmethod
    def _iou_matrix(gtPols, detPols):
        """Pairwise IoU via the native C++ kernel when polygons have uniform
        arity (ICDAR quads); -1 entries (non-convex x non-convex) and
        non-uniform inputs fall back to the numpy path."""
        try:
            gt_sizes = {len(p) for p in gtPols}
            det_sizes = {len(p) for p in detPols}
            if (
                native.native_available()
                and len(gt_sizes) == 1
                and len(det_sizes) == 1
            ):
                mat = native.iou_matrix(
                    np.stack(gtPols).astype(np.float32),
                    np.stack(detPols).astype(np.float32),
                ).astype(np.float64)
                bad = np.argwhere(mat < 0)
                for gi, di in bad:
                    mat[gi, di] = geometry.poly_iou(detPols[di], gtPols[gi])
                return mat
        except Exception:
            pass
        iouMat = np.empty([len(gtPols), len(detPols)])
        for gtNum in range(len(gtPols)):
            for detNum in range(len(detPols)):
                iouMat[gtNum, detNum] = geometry.poly_iou(
                    detPols[detNum], gtPols[gtNum]
                )
        return iouMat

    def combine_results(self, results):
        numGlobalCareGt = 0
        numGlobalCareDet = 0
        matchedSum = 0
        for result in results:
            numGlobalCareGt += result["gtCare"]
            numGlobalCareDet += result["detCare"]
            matchedSum += result["detMatched"]

        methodRecall = (
            0 if numGlobalCareGt == 0 else float(matchedSum) / numGlobalCareGt
        )
        methodPrecision = (
            0 if numGlobalCareDet == 0 else float(matchedSum) / numGlobalCareDet
        )
        methodHmean = (
            0
            if methodRecall + methodPrecision == 0
            else 2 * methodRecall * methodPrecision / (methodRecall + methodPrecision)
        )
        return {
            "precision": methodPrecision,
            "recall": methodRecall,
            "hmean": methodHmean,
        }
