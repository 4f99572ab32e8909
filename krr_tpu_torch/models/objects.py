"""Workload identity: one scannable object per (workload, container).

Mirrors ``K8sObjectData`` (`robusta_krr/core/models/objects.py:8-21`).
"""

from __future__ import annotations

from typing import Optional

import pydantic as pd

from krr_tpu_torch.models.allocations import ResourceAllocations


class K8sObjectData(pd.BaseModel):
    cluster: Optional[str] = None
    name: str
    container: str
    pods: list[str]
    namespace: str
    kind: Optional[str] = None
    allocations: ResourceAllocations

    def __str__(self) -> str:
        return f"{self.kind} {self.namespace}/{self.name}/{self.container}"

    def __hash__(self) -> int:
        return hash(str(self))
