"""Early stopping: config, trainer, savers, terminations, score calculators.

Port of ``deeplearning4j_tpu/earlystopping``. Mirror of reference earlystopping/** (EarlyStoppingConfiguration.java,
trainer/{BaseEarlyStoppingTrainer,EarlyStoppingTrainer}.java, saver/
{InMemoryModelSaver,LocalFileModelSaver}.java, termination/*.java,
scorecalc/DataSetLossCalculator.java — SURVEY.md §2.5).
"""

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (
    EarlyStoppingGraphTrainer,
    EarlyStoppingTrainer,
    IEarlyStoppingTrainer,
    ParallelEarlyStoppingTrainer,
)
from deeplearning4j_tpu_torch.earlystopping.listener import (
    ComposableEarlyStoppingListener,
    EarlyStoppingListener,
    LoggingEarlyStoppingListener,
)
from deeplearning4j_tpu_torch.earlystopping.savers import (
    InMemoryModelSaver,
    LocalFileModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.terminations import (
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.scorecalc import DataSetLossCalculator
