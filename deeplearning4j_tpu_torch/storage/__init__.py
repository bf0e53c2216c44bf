"""Artifact storage backends: local filesystem, S3/GCS/HDFS (gated).
A copy of ``deeplearning4j_tpu/storage`` for the torch package.

Mirror of the reference's storage integrations (SURVEY.md §2.7:
deeplearning4j-aws S3Downloader/S3Uploader/S3ModelSaver;
deeplearning4j-hadoop HdfsModelSaver/HdfsUtils): one ``StorageBackend``
SPI with a local implementation that always works, and remote backends
that activate only when their SDK is importable (no SDKs ship in this
image — they raise a clear error instead of failing deep in a call).
"""

from deeplearning4j_tpu_torch.storage.backends import (
    LocalStorage,
    S3Storage,
    GcsStorage,
    HdfsStorage,
    StorageBackend,
    StorageModelSaver,
    resolve_backend,
)

__all__ = [
    "LocalStorage",
    "S3Storage",
    "GcsStorage",
    "HdfsStorage",
    "StorageBackend",
    "StorageModelSaver",
    "resolve_backend",
]
