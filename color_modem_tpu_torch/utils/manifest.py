"""Chunk manifest for resumable video runs.

Port of ``color_modem_tpu/utils/manifest.py``, with the same JSON layout:
``{"config": {...}, "chunks": {"<start>-<end>": {...}}}``.  Processing is
stateless per frame chunk, so checkpoint and resume are a manifest of the
completed chunks with content fingerprints (``utils/metrics.fingerprint``).
Writes are atomic (a temporary file, then a rename), so an interrupted run
never corrupts it.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any

import numpy as np

MANIFEST_NAME = "manifest.json"


def array_hash(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


class ChunkManifest:
    """Tracks which [start, end) frame ranges are done, with output hashes."""

    def __init__(self, path: str):
        self.path = os.path.join(path, MANIFEST_NAME)
        self.data: dict[str, Any] = {"config": None, "chunks": {}}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.data = json.load(f)

    @staticmethod
    def _key(start: int, end: int) -> str:
        return f"{start}-{end}"

    @staticmethod
    def _normalize(config: dict) -> dict:
        # configs use sparse optional keys, so that a new option does not
        # refuse older manifests; a falsy "nr" counts as absent
        return {k: v for k, v in config.items() if not (k == "nr" and not v)}

    def check_config(self, config: dict) -> None:
        """A manifest written under a different config must not be resumed."""
        if self.data["config"] is None:
            self.data["config"] = config
        elif self._normalize(self.data["config"]) != self._normalize(config):
            raise ValueError(
                f"manifest at {self.path} was written with config "
                f"{self.data['config']}, refusing to resume with {config}"
            )

    def is_done(self, start: int, end: int) -> bool:
        return self._key(start, end) in self.data["chunks"]

    def mark_done(self, start: int, end: int, **info) -> None:
        self.data["chunks"][self._key(start, end)] = info
        self._flush()

    def _flush(self) -> None:
        d = os.path.dirname(self.path)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.data, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def summary(self) -> dict:
        chunks = self.data["chunks"]
        return {
            "chunks_done": len(chunks),
            "frames_done": sum(
                int(k.split("-")[1]) - int(k.split("-")[0]) for k in chunks
            ),
        }
