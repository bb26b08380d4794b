"""Streaming segmentation metrics (counterpart of
``blockcopy_tpu/utils/metrics.py``, reference
``semantic_segmentation/lib/utils/metrics.py:25-148``): confusion-matrix
mIoU, accuracies, frequency-weighted accuracy, fine-class mIoU, and the
keyed ``AverageMeter``."""

from __future__ import annotations

import numpy as np


class StreamSegMetrics:
    """Streaming confusion-matrix metrics for semantic segmentation."""

    def __init__(self, n_classes: int, single_iou_class: int = -1,
                 classes=None, class_names=None):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes))
        self.single_iou_class = single_iou_class
        self.classes = classes  # subset for the "fine" mIoU
        self.class_names = class_names

    def _fast_hist(self, label_true, label_pred):
        mask = (label_true >= 0) & (label_true < self.n_classes)
        return np.bincount(
            self.n_classes * label_true[mask].astype(int) + label_pred[mask],
            minlength=self.n_classes ** 2,
        ).reshape(self.n_classes, self.n_classes)

    def update(self, label_trues, label_preds):
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += self._fast_hist(lt.flatten(),
                                                     lp.flatten())

    def get_results(self) -> dict:
        hist = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                                  - np.diag(hist))
            mean_iu = (np.nanmean(iu) if self.single_iou_class < 0
                       else iu[self.single_iou_class])
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        if self.class_names is not None:
            cls_iu = dict(zip(self.class_names, iu))
        else:
            cls_iu = {i: v for i, v in enumerate(iu)}
        fine_iu = (np.nanmean(iu[self.classes]) if self.classes is not None
                   else 0.0)
        return {
            "Overall Acc": acc,
            "Mean Acc": acc_cls,
            "FreqW Acc": fwavacc,
            "Mean IoU": mean_iu,
            "Class IoU": cls_iu,
            "Fine mIoU": fine_iu,
        }

    @staticmethod
    def to_str(results: dict) -> str:
        return "\n" + "".join(f"{k}: {v:f}\n" for k, v in results.items()
                              if k != "Class IoU")

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))


class AverageMeter:
    """Keyed running averages (reference ``metrics.py:123-148``)."""

    def __init__(self):
        self.book = {}

    def reset_all(self):
        self.book.clear()

    def reset(self, key):
        if key in self.book:
            self.book[key] = [0, 0]

    def update(self, key, val):
        rec = self.book.setdefault(key, [0, 0])
        rec[0] += val
        rec[1] += 1

    def get_results(self, key):
        rec = self.book[key]
        return rec[0] / rec[1]
