"""Workspace: stage manifests and array checkpoints (counterpart of
gappadder_tpu/pipeline/workspace.py).

One directory of named .npz checkpoints plus a JSON manifest recording
which stages completed with which config hash. The names and the
manifest's JSON are the JAX package's, so both packages read and write
one workspace.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np


def _primary() -> bool:
    """Multi-process runs write checkpoints from the primary process
    only (see parallel/mp.py)."""
    from ..parallel import mp
    return mp.is_primary()


class Workspace:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")

    # -- manifest ----------------------------------------------------------
    def _load_manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as fh:
                return json.load(fh)
        return {"stages": {}}

    def mark_done(self, stage: str, config_hash: str, **extra) -> None:
        if not _primary():
            return
        m = self._load_manifest()
        m["stages"][stage] = {"config_hash": config_hash,
                              "time": time.time(), **extra}
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(m, fh, indent=2)
        os.replace(tmp, self._manifest_path)  # atomic vs crashes

    def is_done(self, stage: str, config_hash: str) -> bool:
        st = self._load_manifest()["stages"].get(stage)
        return bool(st) and st["config_hash"] == config_hash

    def stage_info(self, stage: str) -> dict | None:
        return self._load_manifest()["stages"].get(stage)

    # -- arrays ------------------------------------------------------------
    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def save_arrays(self, name: str, **arrays) -> None:
        if not _primary():
            return
        np.savez_compressed(self.path(name + ".npz"), **arrays)

    def load_arrays(self, name: str) -> dict[str, np.ndarray]:
        with np.load(self.path(name + ".npz"), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def has_arrays(self, name: str) -> bool:
        return os.path.exists(self.path(name + ".npz"))

    def save_json(self, name: str, obj) -> None:
        if not _primary():
            return
        with open(self.path(name + ".json"), "w") as fh:
            json.dump(obj, fh)

    def load_json(self, name: str):
        with open(self.path(name + ".json")) as fh:
            return json.load(fh)


def config_hash(cfg) -> str:
    """Stable hash of the stage-relevant config fields."""
    d = dataclasses.asdict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
