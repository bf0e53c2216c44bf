from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
