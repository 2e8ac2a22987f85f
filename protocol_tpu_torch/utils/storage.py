"""Storage providers: artifact uploads via signed URLs
(``protocol_tpu/utils/storage.py``, copied).

Reference: crates/shared/src/utils/mod.rs — ``StorageProvider`` trait
{file_exists, generate_mapping_file, resolve_mapping_for_sha,
generate_upload_signed_url} (:9-28) with ``MockStorageProvider`` (:30-110)
and a GCS implementation (google_cloud.rs). Here: the same trait shape, the
in-memory mock for tests, and a local-directory provider for dev clusters
(upload "signed URLs" are file:// paths plus an HMAC token — the seam where
a real GCS/S3 backend would plug in).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time
from abc import ABC, abstractmethod
from typing import Optional


class StorageProvider(ABC):
    @abstractmethod
    async def file_exists(self, object_name: str) -> bool: ...

    @abstractmethod
    async def generate_upload_signed_url(
        self,
        object_name: str,
        content_type: Optional[str] = None,
        expires_in: float = 3600.0,
        max_bytes: Optional[int] = None,
    ) -> str: ...

    @abstractmethod
    async def generate_mapping_file(self, sha256: str, file_name: str) -> None:
        """Write ``mapping/{sha256}`` -> file name (used by the validator to
        resolve work keys to artifacts)."""

    @abstractmethod
    async def resolve_mapping_for_sha(self, sha256: str) -> Optional[str]: ...


class MockStorageProvider(StorageProvider):
    """In-memory provider (shared/src/utils/mod.rs:30-110)."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.mappings: dict[str, str] = {}
        self.issued_urls: list[str] = []

    async def file_exists(self, object_name: str) -> bool:
        return object_name in self.files

    async def generate_upload_signed_url(
        self, object_name, content_type=None, expires_in=3600.0, max_bytes=None
    ) -> str:
        url = f"mock://upload/{object_name}?expires={int(time.time() + expires_in)}"
        self.issued_urls.append(url)
        return url

    async def generate_mapping_file(self, sha256: str, file_name: str) -> None:
        self.mappings[sha256] = file_name
        self.files[f"mapping/{sha256}"] = file_name.encode()

    async def resolve_mapping_for_sha(self, sha256: str) -> Optional[str]:
        return self.mappings.get(sha256)

    # test helper: simulate the worker completing an upload
    async def put(self, object_name: str, data: bytes) -> None:
        self.files[object_name] = data


class LocalDirStorageProvider(StorageProvider):
    """Filesystem-backed provider for dev deployments; URLs carry an HMAC
    token so the upload endpoint can reject unsigned paths."""

    def __init__(
        self,
        root: str,
        secret: bytes = b"dev-secret",
        public_base_url: str = "",
    ):
        self.root = root
        self.secret = secret
        # when set, signed URLs are HTTP PUT endpoints (served by the
        # orchestrator's /storage/upload route) instead of file:// paths
        self.public_base_url = public_base_url.rstrip("/")
        os.makedirs(root, exist_ok=True)

    def _path(self, object_name: str) -> str:
        # object names are worker-controlled: normalize, strip any absolute
        # prefix, and refuse paths that escape the storage root
        safe = os.path.normpath(object_name).lstrip(os.sep)
        if safe.startswith(".."):
            raise ValueError(f"object name escapes storage root: {object_name!r}")
        full = os.path.join(self.root, safe)
        if os.path.commonpath([os.path.abspath(full), os.path.abspath(self.root)]) != os.path.abspath(self.root):
            raise ValueError(f"object name escapes storage root: {object_name!r}")
        return full

    def _token(self, object_name: str, expires: int, max_bytes: int) -> str:
        # max_bytes is part of the signed payload: the approved size is
        # enforceable at upload time (GCS content-length-range semantics)
        return hmac.new(
            self.secret,
            f"{object_name}|{expires}|{max_bytes}".encode(),
            hashlib.sha256,
        ).hexdigest()[:32]

    async def file_exists(self, object_name: str) -> bool:
        return os.path.exists(self._path(object_name))

    async def generate_upload_signed_url(
        self, object_name, content_type=None, expires_in=3600.0, max_bytes=None
    ) -> str:
        from urllib.parse import quote

        # reject escaping names when the URL is issued (the token would otherwise
        # validate while the write later fails)
        self._path(object_name)
        expires = int(time.time() + expires_in)
        size_cap = int(max_bytes) if max_bytes else 0
        token = self._token(object_name, expires, size_cap)
        if self.public_base_url:
            return (
                f"{self.public_base_url}/storage/upload/{quote(object_name, safe='/')}"
                f"?expires={expires}&max_bytes={size_cap}&token={token}"
            )
        return (
            f"file://{self._path(object_name)}"
            f"?expires={expires}&max_bytes={size_cap}&token={token}"
        )

    async def put(self, object_name: str, data: bytes) -> None:
        path = self._path(object_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    async def put_stream(self, object_name: str, chunk_iter, cap: int) -> int:
        """Stream chunks to disk; deletes the partial file and raises
        ValueError if the running total exceeds ``cap``. Returns bytes
        written."""
        path = self._path(object_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        total = 0
        tmp = path + ".part"
        try:
            with open(tmp, "wb") as f:
                async for chunk in chunk_iter:
                    total += len(chunk)
                    if total > cap:
                        raise ValueError("upload exceeds approved size")
                    f.write(chunk)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return total

    def verify_upload_url(
        self, object_name: str, expires: int, token: str, max_bytes: int = 0
    ) -> bool:
        if time.time() > expires:
            return False
        return hmac.compare_digest(
            self._token(object_name, expires, max_bytes), token
        )

    async def generate_mapping_file(self, sha256: str, file_name: str) -> None:
        path = self._path(f"mapping/{sha256}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(file_name)

    async def resolve_mapping_for_sha(self, sha256: str) -> Optional[str]:
        path = self._path(f"mapping/{sha256}")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()
