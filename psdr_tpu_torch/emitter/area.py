"""One-sided constant-radiance area light attached to a mesh. Counterpart
of ``psdr_tpu/emitter/area.py``."""
from __future__ import annotations

import numpy as np


class AreaLight:
    kind = "area"

    def __init__(self, radiance, mesh_index: int, emitter_id: str = ""):
        self.radiance = np.asarray(radiance, np.float32)
        self.mesh_index = int(mesh_index)
        self.id = emitter_id

    def params(self) -> dict:
        return {"radiance": self.radiance}

    def set_params(self, p: dict) -> None:
        self.radiance = p["radiance"]

    def __repr__(self):
        return f"AreaLight[radiance={self.radiance}, mesh={self.mesh_index}]"
