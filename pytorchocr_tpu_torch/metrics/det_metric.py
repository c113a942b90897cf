"""Detection metric — the port's copy of pytorchocr_tpu/metrics/det_metric.py:8."""

from .eval_det_iou import DetectionIoUEvaluator

__all__ = ["DetMetric"]


class DetMetric:
    def __init__(self, main_indicator="hmean", **kwargs):
        self.evaluator = DetectionIoUEvaluator()
        self.main_indicator = main_indicator
        self.reset()

    def __call__(self, preds, batch, **kwargs):
        gt_polyons_batch = batch[2]
        ignore_tags_batch = batch[3]
        for pred, gt_polyons, ignore_tags in zip(
            preds, gt_polyons_batch, ignore_tags_batch
        ):
            gt_info_list = [
                {"points": gt_polyon, "text": "", "ignore": bool(ignore_tag)}
                for gt_polyon, ignore_tag in zip(gt_polyons, ignore_tags)
            ]
            det_info_list = [
                {"points": det_polyon, "text": ""} for det_polyon in pred["points"]
            ]
            result = self.evaluator.evaluate_image(gt_info_list, det_info_list)
            self.results.append(result)

    def get_metric(self):
        metrics = self.evaluator.combine_results(self.results)
        self.reset()
        return metrics

    def reset(self):
        self.results = []
