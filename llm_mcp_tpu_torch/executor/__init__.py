"""Generation and embedding engines of the port, and the model zoo."""

from .embedding import EmbeddingEngine
from .engine import GenerationEngine, GenRequest, SliceEngine
from .zoo import ModelZoo

__all__ = ["EmbeddingEngine", "GenerationEngine", "GenRequest", "ModelZoo", "SliceEngine"]
