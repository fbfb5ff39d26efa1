"""Architecture registry: --arch <id> -> ArchConfig (the counterpart of
:mod:`repro.configs`)."""
from .base import ArchConfig, ShapeConfig, SHAPES, reduce_for_smoke

from .starcoder2_7b import CONFIG as _starcoder2
from .mistral_nemo_12b import CONFIG as _nemo
from .qwen15_32b import CONFIG as _qwen
from .chatglm3_6b import CONFIG as _chatglm
from .llama32_vision_90b import CONFIG as _llama_v
from .recurrentgemma_2b import CONFIG as _rgemma
from .kimi_k2_1t import CONFIG as _kimi
from .phi35_moe_42b import CONFIG as _phi
from .mamba2_130m import CONFIG as _mamba2
from .seamless_m4t_medium import CONFIG as _seamless

ARCHS = {c.name: c for c in [
    _starcoder2, _nemo, _qwen, _chatglm, _llama_v,
    _rgemma, _kimi, _phi, _mamba2, _seamless,
]}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
