"""Evaluation of the port: the confusion matrix, `Evaluation`, and the
held-out evaluation of a checkpoint (`eval/holdout.py`)."""

from deeplearning4j_tpu_torch.eval.confusion import ConfusionMatrix  # noqa: F401
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.holdout import (  # noqa: F401
    evaluate_checkpoint,
    load_holdout_csv,
)
