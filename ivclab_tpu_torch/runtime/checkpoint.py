"""Per-GOP checkpoint / resume for long video encodes.

Port of ``ivclab_tpu/runtime/checkpoint.py`` (numpy only). The unit of
recovery is the GOP: each GOP's bitstream and reconstructions are written
atomically (temporary file + rename), so a crashed run re-encodes only the
GOPs it had not finished. The files are the JAX package's: either package
resumes from the other's directory.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class GopCheckpointer:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "manifest.json"

    def _load_manifest(self) -> dict:
        if self.manifest_path.exists():
            return json.loads(self.manifest_path.read_text())
        return {"gops": {}}

    def completed_gops(self) -> list[int]:
        return sorted(int(k) for k in self._load_manifest()["gops"])

    def save_gop(self, gop_index: int, payload: bytes, recon: np.ndarray, bits: np.ndarray):
        """Persist one GOP atomically (tmp + rename)."""
        stem = self.dir / f"gop_{gop_index:05d}"
        tmp = stem.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                payload=np.frombuffer(payload, dtype=np.uint8),
                recon=np.asarray(recon),
                bits=np.asarray(bits),
            )
        tmp.rename(stem.with_suffix(".npz"))
        manifest = self._load_manifest()
        manifest["gops"][str(gop_index)] = {
            "file": stem.with_suffix(".npz").name,
            "bits": int(np.sum(bits)),
        }
        mtmp = self.manifest_path.with_suffix(".json.tmp")
        mtmp.write_text(json.dumps(manifest, indent=1))
        mtmp.rename(self.manifest_path)

    def load_gop(self, gop_index: int):
        """-> (payload bytes, recon array, bits) or None if absent."""
        path = self.dir / f"gop_{gop_index:05d}.npz"
        if not path.exists():
            return None
        with np.load(path) as z:
            return bytes(z["payload"].tobytes()), z["recon"], z["bits"]

    def resume_plan(self, total_gops: int) -> list[int]:
        """GOP indices still to encode."""
        done = set(self.completed_gops())
        return [g for g in range(total_gops) if g not in done]
