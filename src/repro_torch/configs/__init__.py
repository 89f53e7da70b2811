"""Architecture registry: ``get_config(arch_id, smoke=False)`` + shapes.

Holds the recsys archs ported so far (SASRec); Wide&Deep, BST and MIND
join with their towers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig, RecsysShape

_MODULES: Dict[str, str] = {
    "sasrec": "sasrec",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> RecsysConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"arch {arch_id!r} is not ported yet; ported: "
                         f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["RecsysConfig", "RecsysShape", "RECSYS_SHAPES", "list_archs",
           "get_config"]
