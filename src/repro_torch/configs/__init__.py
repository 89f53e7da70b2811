"""Architecture registry: ``get_config(arch_id, smoke=False)`` + shape
sets.

Twin of ``repro/configs/__init__.py``: the dense LMs (TinyLlama-1.1B,
Yi-6B, Llama-3-8B), the MoE LMs (Arctic-480B, Granite-MoE-1B-A400M), the
GNN (GIN-TU) and the four recsys towers (Wide&Deep, SASRec, BST, MIND),
with the 40 (arch, shape) cells of the reference's dry run. The port's
own archs (Moonlight-16B-A3B, ``configs/mla.py``) resolve by name but
are not listed: ``list_archs()`` and ``all_cells()`` are the reference's.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Union

from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                      GNNConfig, GNNShape, LMConfig, LMShape,
                                      MoEConfig, RecsysConfig, RecsysShape)

_MODULES: Dict[str, str] = {
    "yi-6b": "yi_6b",
    "llama3-8b": "llama3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "arctic-480b": "arctic_480b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "gin-tu": "gin_tu",
    "wide-deep": "wide_deep",
    "sasrec": "sasrec",
    "bst": "bst",
    "mind": "mind",
}
# archs the port runs and the reference has not: get_config resolves them,
# list_archs() and all_cells() leave them out
_PORT_ONLY: Dict[str, str] = {
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}

SHAPES_BY_FAMILY = {
    "lm": LM_SHAPES,
    "gnn": GNN_SHAPES,
    "recsys": RECSYS_SHAPES,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str, smoke: bool = False
               ) -> Union[LMConfig, GNNConfig, RecsysConfig]:
    name = _MODULES.get(arch_id, _PORT_ONLY.get(arch_id))
    if name is None:
        raise ValueError(f"unknown arch {arch_id!r}; archs: {list_archs()}"
                         f" and the port's {list(_PORT_ONLY)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.CONFIG


def shapes_for(cfg) -> Dict[str, object]:
    return SHAPES_BY_FAMILY[cfg.family]


def all_cells() -> List[tuple]:
    """The 40 (arch, shape) cells."""
    return [(arch, shape) for arch in list_archs()
            for shape in shapes_for(get_config(arch))]


__all__ = [
    "LMConfig", "LMShape", "MoEConfig", "GNNConfig", "GNNShape",
    "RecsysConfig", "RecsysShape", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
    "list_archs", "get_config", "shapes_for", "all_cells",
]
