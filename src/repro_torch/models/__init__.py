"""Language models (port of ``repro/models``): every family of
``repro_torch.configs.ARCH_IDS``.

``build_model(cfg)`` (``api.py``) over ``common`` (dense layers, norms,
RoPE), ``attention`` (chunked online-softmax attention, the ring-buffer
decode cache), ``ffn`` (dense or sparse FFN), ``moe`` (sorted-token
expert dispatch), ``ssm`` (Mamba) and ``rglru`` (RG-LRU) over
``scan_utils`` (the chunked linear scan), ``blocks`` and
``transformer`` (the layer stack).  Configs come from
``repro_torch.configs``.
"""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
