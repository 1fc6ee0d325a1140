"""Film checkpoint/resume: npz snapshots of the accumulation buffers.

The reference keeps its film in VRAM only — a crash loses every sample
(SURVEY.md §5). Here the host-side film is snapshotted every log batch and
`--resume` continues from the last snapshot. Snapshots carry a scene/config
fingerprint so resuming against a different scene or seed refuses
instead of silently blending mismatched sample sums into the film.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("rene_tpu.checkpoint")


def scene_fingerprint(buffers_np: dict, config, seed) -> str:
    """Stable hash of the facts that make two accumulations compatible:
    the flat scene buffers, the static config and the host seed."""
    h = hashlib.sha1()
    h.update(repr(config).encode())
    h.update(f"seed={int(seed)}".encode())
    for k in sorted(buffers_np):
        v = np.ascontiguousarray(buffers_np[k])
        h.update(k.encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, accum: dict, samples_done: int,
                    fingerprint: str = "") -> None:
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, samples_done=samples_done,
                        fingerprint=np.bytes_(fingerprint.encode()), **accum)
    os.replace(tmp, path)


def load_checkpoint(path: str,
                    fingerprint: str = "") -> Optional[Tuple[dict, int]]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        saved = bytes(z["fingerprint"]).decode() if "fingerprint" in z else ""
        if fingerprint and saved and saved != fingerprint:
            log.warning(
                "checkpoint %s was written for a different scene/seed; "
                "ignoring it (delete the file to silence this)",
                path)
            return None
        accum = {k: z[k] for k in ("radiance", "normal", "albedo")}
        return accum, int(z["samples_done"])
