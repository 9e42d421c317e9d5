"""Serving layer of the port: the engine backend seam."""
from repro_torch.serving.backends import EngineBackend, StaticBackend

__all__ = ["EngineBackend", "StaticBackend"]
