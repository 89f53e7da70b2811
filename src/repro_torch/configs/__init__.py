"""Architecture registry: ``get_config(arch_id, smoke=False)`` + shapes.

Holds the archs ported so far: the dense LMs (TinyLlama-1.1B, Yi-6B,
Llama-3-8B), the MoE LMs (Arctic-480B, Granite-MoE-1B-A400M) and the four
recsys towers (Wide&Deep, SASRec, BST, MIND). The GNN (GIN-TU) joins with
the scale-out slice.
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
    "arctic-480b": "arctic_480b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "wide-deep": "wide_deep",
    "sasrec": "sasrec",
    "bst": "bst",
    "mind": "mind",
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
