"""StorageBackend SPI + implementations (a copy of
``deeplearning4j_tpu/storage/backends.py``, framework-free).

URIs: ``file:///abs/path`` or bare paths → LocalStorage;
``s3://bucket/key`` → S3Storage (needs boto3); ``gs://bucket/key`` →
GcsStorage (needs google-cloud-storage); ``hdfs://host/path`` →
HdfsStorage (needs a hadoop client). Remote SDKs are not in this image,
so those backends raise RuntimeError at construction with install hints
— the SPI and wiring are in place for deployments that have them
(reference deeplearning4j-aws BaseS3.java connects lazily the same way).
"""

from __future__ import annotations

import os
import shutil
from typing import List
from urllib.parse import urlparse


class StorageBackend:
    """Byte-artifact store: put/get/exists/list/delete on keys."""

    def put(self, local_path: str, key: str) -> None:
        raise NotImplementedError

    def get(self, key: str, local_path: str) -> str:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class LocalStorage(StorageBackend):
    """Filesystem-rooted store (always available; the test double for
    the remote backends, like the reference's local savers)."""

    def __init__(self, root: str):
        # root is created lazily on first put — resolving a read path
        # must not leave stray directories behind
        self.root = os.path.abspath(root)

    def _path(self, key: str) -> str:
        path = os.path.abspath(os.path.join(self.root, key))
        if not path.startswith(self.root + os.sep) and path != self.root:
            raise ValueError(f"key {key!r} escapes storage root")
        return path

    def put(self, local_path: str, key: str) -> None:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(local_path, dst)

    def get(self, key: str, local_path: str) -> str:
        src = self._path(key)
        if not os.path.exists(src):
            raise FileNotFoundError(f"no such key: {key}")
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        shutil.copyfile(src, local_path)
        return local_path

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn),
                                      self.root)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.unlink(path)


def _gated(name: str, module: str, hint: str):
    try:
        __import__(module)
        return None
    except ImportError:
        return RuntimeError(
            f"{name} backend requires {module!r} which is not installed "
            f"in this environment ({hint}); use LocalStorage or install "
            "the SDK in your deployment image")


class S3Storage(StorageBackend):
    """S3 artifact store (reference deeplearning4j-aws S3Downloader/
    S3Uploader/S3ModelSaver). Activates only when boto3 exists."""

    def __init__(self, bucket: str):
        err = _gated("S3", "boto3", "pip install boto3")
        if err:
            raise err
        import boto3  # pragma: no cover - no SDK in CI image

        self.bucket = bucket
        self._client = boto3.client("s3")

    # pragma: no cover - requires live SDK/credentials
    def put(self, local_path: str, key: str) -> None:
        self._client.upload_file(local_path, self.bucket, key)

    def get(self, key: str, local_path: str) -> str:
        self._client.download_file(self.bucket, key, local_path)
        return local_path

    def exists(self, key: str) -> bool:
        import botocore.exceptions

        try:
            self._client.head_object(Bucket=self.bucket, Key=key)
            return True
        except botocore.exceptions.ClientError:
            return False

    def list(self, prefix: str = "") -> List[str]:
        paginator = self._client.get_paginator("list_objects_v2")
        keys: List[str] = []
        for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
            keys.extend(o["Key"] for o in page.get("Contents", []))
        return keys

    def delete(self, key: str) -> None:
        self._client.delete_object(Bucket=self.bucket, Key=key)


class GcsStorage(StorageBackend):
    """GCS artifact store; activates only when google-cloud-storage
    exists (the object store counterpart of the reference's
    S3 module)."""

    def __init__(self, bucket: str):
        err = _gated("GCS", "google.cloud.storage",
                     "pip install google-cloud-storage")
        if err:
            raise err
        from google.cloud import storage  # pragma: no cover

        self._bucket = storage.Client().bucket(bucket)

    def put(self, local_path: str, key: str) -> None:  # pragma: no cover
        self._bucket.blob(key).upload_from_filename(local_path)

    def get(self, key: str, local_path: str) -> str:  # pragma: no cover
        self._bucket.blob(key).download_to_filename(local_path)
        return local_path

    def exists(self, key: str) -> bool:  # pragma: no cover
        return self._bucket.blob(key).exists()

    def list(self, prefix: str = "") -> List[str]:  # pragma: no cover
        return [b.name for b in self._bucket.list_blobs(prefix=prefix)]

    def delete(self, key: str) -> None:  # pragma: no cover
        self._bucket.blob(key).delete()


class HdfsStorage(StorageBackend):
    """HDFS store (reference deeplearning4j-hadoop HdfsModelSaver/
    HdfsUtils); activates only when a client library exists."""

    def __init__(self, url: str):
        err = _gated("HDFS", "pyarrow", "pip install pyarrow")
        if err:
            raise err
        raise RuntimeError(
            "HDFS backend scaffolding present but no HDFS cluster is "
            "reachable from this environment")


def resolve_backend(uri: str) -> tuple:
    """URI → (backend, key). file:// and bare paths are local."""
    parsed = urlparse(uri)
    if parsed.scheme in ("", "file"):
        path = parsed.path if parsed.scheme else uri
        return LocalStorage(os.path.dirname(path) or "."), \
            os.path.basename(path)
    if parsed.scheme == "s3":
        return S3Storage(parsed.netloc), parsed.path.lstrip("/")
    if parsed.scheme == "gs":
        return GcsStorage(parsed.netloc), parsed.path.lstrip("/")
    if parsed.scheme == "hdfs":
        return HdfsStorage(uri), parsed.path.lstrip("/")
    raise ValueError(f"unknown storage scheme: {parsed.scheme!r}")


class StorageModelSaver:
    """Save/load model zips through any backend (reference S3ModelSaver /
    HdfsModelSaver over the single-zip ModelSerializer format)."""

    def __init__(self, backend: StorageBackend, key: str):
        self.backend = backend
        self.key = key

    def save(self, net) -> None:
        import tempfile

        from deeplearning4j_tpu_torch.util.model_serializer import write_model

        with tempfile.TemporaryDirectory() as d:
            tmp = os.path.join(d, "model.zip")
            write_model(net, tmp)
            self.backend.put(tmp, self.key)

    def load(self, device="cuda"):
        """The saved net, restored onto ``device`` (the card unless the
        caller asks for another)."""
        import tempfile

        from deeplearning4j_tpu_torch.util.model_serializer import restore_model

        with tempfile.TemporaryDirectory() as d:
            tmp = os.path.join(d, "model.zip")
            self.backend.get(self.key, tmp)
            return restore_model(tmp, device=device)


class StorageLock:
    """Dataset-paths lock over any storage backend.

    The equivalent of the reference HdfsLock (reference
    deeplearning4j-hadoop/.../util/HdfsLock.java): a lock node records the
    list of artifact keys it guards; ``is_locked`` auto-clears the lock
    when any guarded key has disappeared (the reference's "paths found to
    be inconsistent" sweep), so a crashed writer never wedges the dataset.
    The ZooKeeper node becomes a lock key in the backend itself.
    """

    def __init__(self, backend: StorageBackend, lock_key: str = "hdfslock2"):
        self.backend = backend
        self.lock_key = lock_key

    def create(self, keys: List[str]) -> None:
        import tempfile

        with tempfile.NamedTemporaryFile("w", suffix=".lock",
                                         delete=False) as f:
            f.write("\n".join(keys) + "\n")
            tmp = f.name
        try:
            self.backend.put(tmp, self.lock_key)
        finally:
            os.unlink(tmp)

    def get_paths(self) -> List[str]:
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            local = self.backend.get(self.lock_key, os.path.join(d, "lock"))
            with open(local) as f:
                return [line.strip() for line in f if line.strip()]

    def is_locked(self) -> bool:
        if not self.backend.exists(self.lock_key):
            return False
        try:
            for key in self.get_paths():
                if not self.backend.exists(key):
                    self.delete()
                    return False
        except FileNotFoundError:
            # lock node vanished between exists() and get(): unlocked
            return False
        return True

    def delete(self) -> None:
        if self.backend.exists(self.lock_key):
            self.backend.delete(self.lock_key)

    def close(self) -> None:
        self.delete()
