"""Generation engine of the port."""

from .engine import GenerationEngine, GenRequest

__all__ = ["GenerationEngine", "GenRequest"]
