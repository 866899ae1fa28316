from deeplearning4j_tpu_torch.eval.confusion import ConfusionMatrix  # noqa: F401
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation  # noqa: F401
