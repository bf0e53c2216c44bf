"""Nearest-neighbour structures of the torch package: the vantage-point
tree (``vptree.py``) behind ``nlp.model_utils.TreeModelUtils``."""

from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401

__all__ = ["VPTree"]
