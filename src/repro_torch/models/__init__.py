"""Language models (port of ``repro/models``): the dense decoder family.

``build_model(cfg)`` (``api.py``) over ``common`` (dense layers, norms,
RoPE), ``attention`` (chunked online-softmax attention, the ring-buffer
decode cache), ``ffn`` (dense or sparse FFN), ``blocks`` and
``transformer`` (the layer stack).  Configs come from
``repro_torch.configs``.
"""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
