"""Architecture registry: every config of ``repro.configs``, one module per
architecture."""

from __future__ import annotations

import importlib

ARCHS = [
    "llama_3_2_vision_11b",
    "olmoe_1b_7b",
    "moonshot_v1_16b_a3b",
    "stablelm_3b",
    "command_r_plus_104b",
    "stablelm_12b",
    "gemma3_27b",
    "zamba2_1_2b",
    "mamba2_130m",
    "seamless_m4t_large_v2",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str, **overrides):
    mod_name = _ALIAS.get(name, name).replace("-", "_")
    if mod_name not in ARCHS:
        raise ValueError(f"arch {name!r} is not ported yet; ported: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.config()
    return cfg.replace(**overrides) if overrides else cfg


def all_arch_names():
    return list(ARCHS)
