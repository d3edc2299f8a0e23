"""Generation and embedding engines of the port."""

from .embedding import EmbeddingEngine
from .engine import GenerationEngine, GenRequest

__all__ = ["EmbeddingEngine", "GenerationEngine", "GenRequest"]
