"""Loss layers (the port of ``paddle_tpu/nn/layer/loss.py``)."""
from __future__ import annotations

from ... import ops
from .layers import Layer

__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
    "HingeEmbeddingLoss",
]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):  # noqa: A002
        return ops.cross_entropy(
            input, label, soft_label=self.soft_label,
            ignore_index=self.ignore_index, reduction=self.reduction,
            axis=self.axis, weight=self.weight, use_softmax=self.use_softmax)


class _Reduced(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class MSELoss(_Reduced):
    def forward(self, input, label):  # noqa: A002
        return ops.mse_loss(input, label, reduction=self.reduction)


class L1Loss(_Reduced):
    def forward(self, input, label):  # noqa: A002
        return ops.l1_loss(input, label, reduction=self.reduction)


class KLDivLoss(_Reduced):
    def forward(self, input, label):  # noqa: A002
        return ops.kl_div(input, label, reduction=self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return ops.nll_loss(input, label, weight=self.weight,
                            ignore_index=self.ignore_index,
                            reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return ops.binary_cross_entropy(input, label, weight=self.weight,
                                        reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return ops.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return ops.smooth_l1_loss(input, label, reduction=self.reduction,
                                  delta=self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return ops.margin_ranking_loss(input, other, label,
                                       margin=self.margin,
                                       reduction=self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean"):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return ops.hinge_embedding_loss(input, label, margin=self.margin,
                                        reduction=self.reduction)
