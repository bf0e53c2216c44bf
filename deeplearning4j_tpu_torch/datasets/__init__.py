"""Data pipeline: DataSet container, iterators, built-in datasets,
records, disk-streaming iterators and the synthetic Markov LM task
(numpy-only copies of the modules of ``deeplearning4j_tpu/datasets``).

Mirror of reference datasets/** (DataSetIterator.java:54, mnist/*,
iterator/impl/*, canova adapters — SURVEY.md §2.4). Host-side, feeding
the net's device; ``native_rt.NativeAsyncDataSetIterator`` overlaps host
reads with training like the reference's prefetch thread.
"""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    AsyncDataSetIterator,
    BaseDataSetIterator,
    DataSetIterator,
    ListDataSetIterator,
    MovingWindowDataSetIterator,
    MultipleEpochsIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
    TestDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.rearrange import (  # noqa: F401
    LocalUnstructuredDataFormatter,
)
