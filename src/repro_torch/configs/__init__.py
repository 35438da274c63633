from .base import (
    ARCH_IDS,
    ArchConfig,
    SHAPES,
    ShapeConfig,
    get,
    list_archs,
    smoke,
)

__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeConfig", "get",
           "list_archs", "smoke"]
