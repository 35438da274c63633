"""Training data: the deterministic synthetic LM pipeline."""
from .pipeline import SyntheticLM, for_config

__all__ = ["SyntheticLM", "for_config"]
