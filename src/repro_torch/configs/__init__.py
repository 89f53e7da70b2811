"""Architecture registry: ``get_config(arch_id, smoke=False)`` + shapes.

Holds the archs ported so far: the dense LMs (TinyLlama-1.1B, Yi-6B,
Llama-3-8B) and SASRec. The MoE LMs (Granite, Arctic), Wide&Deep, BST and
MIND join with their towers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Union

from repro_torch.configs.base import (LM_SHAPES, RECSYS_SHAPES, LMConfig,
                                      LMShape, MoEConfig, RecsysConfig,
                                      RecsysShape)

_MODULES: Dict[str, str] = {
    "yi-6b": "yi_6b",
    "llama3-8b": "llama3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "sasrec": "sasrec",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str, smoke: bool = False
               ) -> Union[LMConfig, RecsysConfig]:
    if arch_id not in _MODULES:
        raise ValueError(f"arch {arch_id!r} is not ported yet; ported: "
                         f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["LMConfig", "LMShape", "MoEConfig", "LM_SHAPES", "RecsysConfig",
           "RecsysShape", "RECSYS_SHAPES", "list_archs", "get_config"]
