"""Python-side streaming metric accumulators, copied from the JAX package
(Fluid's python/paddle/fluid/metrics.py: MetricBase, CompositeMetric,
Precision, Recall, Accuracy, ChunkEvaluator, EditDistance, DetectionMAP,
Auc).  NumPy only; ``DetectionMAP`` keeps its own copy of the JAX
package's VOC mAP (``np_detection_map``), whose detection ops are not
ported yet."""
from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k in list(self.__dict__):
            if not k.startswith("_"):
                self.__dict__[k] = 0.0
        self._reset_state()

    def _reset_state(self):
        """Hook for metrics whose state lives in private attrs."""

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def _reset_state(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated into Accuracy")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).ravel()
        labels = np.asarray(labels).astype(np.int64).ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).ravel()
        labels = np.asarray(labels).astype(np.int64).ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    """Streaming AUC with threshold buckets (reference metrics.py Auc)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def _reset_state(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).ravel()
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds
        buckets = np.clip((pos_prob * self._num_thresholds).astype(int),
                          0, self._num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # walk thresholds from high to low accumulating trapezoids
        area = 0.0
        pos = neg = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data updated into EditDistance")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class ChunkEvaluator(MetricBase):
    """Accumulates chunk_eval op outputs across batches (reference
    fluid/metrics.py ChunkEvaluator): update with the three counts, eval
    returns (precision, recall, f1)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        p = (self.num_correct_chunks / self.num_infer_chunks
             if self.num_infer_chunks else 0.0)
        r = (self.num_correct_chunks / self.num_label_chunks
             if self.num_label_chunks else 0.0)
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1


class DetectionMAP(MetricBase):
    """Accumulates per-batch padded detections/ground truth and computes
    VOC mAP on eval (reference fluid/metrics.py DetectionMAP;
    ``np_detection_map`` below, the JAX package's)."""

    def __init__(self, name=None, class_num=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__(name)
        # config in _-prefixed attrs (the Auc pattern): MetricBase.reset()
        # zeroes public attrs, which must only ever be accumulator state
        self._class_num = class_num
        self._overlap_threshold = overlap_threshold
        self._evaluate_difficult = evaluate_difficult
        self._ap_version = ap_version
        self._batches = []

    def _reset_state(self):
        self._batches = []

    def update(self, detections, det_lens, gt, gt_lens):
        """detections [B,D,6] rows [label,score,box]; gt [B,G,6] rows
        [label,box,is_difficult]; lens = valid counts per image."""
        self._batches.append((np.asarray(detections), np.asarray(det_lens),
                              np.asarray(gt), np.asarray(gt_lens)))

    def eval(self):
        if not self._batches:
            raise ValueError("no data updated into DetectionMAP")
        maps = [float(np_detection_map(
            d, dl, g, gl, self._class_num, self._overlap_threshold,
            self._ap_version, self._evaluate_difficult))
            for d, dl, g, gl in self._batches]
        return float(np.mean(maps))


def np_detection_map(det, det_lens, gt, gt_lens, class_num,
                     overlap_threshold=0.5, ap_type="integral",
                     evaluate_difficult=True):
    """VOC mAP (reference detection_map_op.cc semantics).  det [B, D, 6]
    rows [label, score, box]; gt [B, G, 6] rows [label, xmin, ymin, xmax,
    ymax, is_difficult]."""
    det, gt = np.asarray(det, np.float64), np.asarray(gt, np.float64)
    aps = []
    for c in range(class_num):
        scores, tps = [], []
        n_pos = 0
        for b in range(det.shape[0]):
            g = gt[b, : int(gt_lens[b])]
            g = g[g[:, 0] == c]
            diff = g[:, 5] > 0.5
            if evaluate_difficult:
                n_pos += len(g)
            else:
                n_pos += int((~diff).sum())
            d = det[b, : int(det_lens[b])]
            d = d[d[:, 0] == c]
            d = d[np.argsort(-d[:, 1])]
            taken = np.zeros(len(g), bool)
            for row in d:
                scores.append(row[1])
                if len(g) == 0:
                    tps.append(0)
                    continue
                ious = np.array([_np_iou(row[2:6], gb[1:5]) for gb in g])
                j = int(np.argmax(ious))
                if ious[j] >= overlap_threshold:
                    if not evaluate_difficult and diff[j]:
                        scores.pop()          # skip difficult matches
                        continue
                    if not taken[j]:
                        tps.append(1)
                        taken[j] = True
                    else:
                        tps.append(0)
                else:
                    tps.append(0)
        if n_pos == 0:
            continue
        if not scores:
            aps.append(0.0)
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(tps, np.float64)[order]
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(1 - tp)
        rec = tp_cum / n_pos
        prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        if ap_type == "11point":
            ap = 0.0
            for t in np.arange(0.0, 1.01, 0.1):
                p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
                ap += p / 11.0
        else:                                   # integral
            ap = 0.0
            prev_rec = 0.0
            for p, rv in zip(prec, rec):
                ap += p * (rv - prev_rec)
                prev_rec = rv
        aps.append(float(ap))
    return np.float32(np.mean(aps) if aps else 0.0)


def _np_iou(a, b):
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[0] * wh[1]
    ua = max((a[2] - a[0]) * (a[3] - a[1]), 0) + \
        max((b[2] - b[0]) * (b[3] - b[1]), 0) - inter
    return inter / ua if ua > 0 else 0.0
