"""Data containers and the synthetic Markov LM task (numpy-only copies
of ``deeplearning4j_tpu/datasets/dataset.py`` and ``markov.py``)."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    MultiDataSet,
)
