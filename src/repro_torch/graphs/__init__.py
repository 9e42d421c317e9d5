"""Graph generators (numpy-seeded; return ``repro_torch.core.graph.Graph``)."""
from repro_torch.graphs.generators import (
    grid_road,
    kronecker,
    uniform_gnp,
    webgraph,
)

__all__ = ["uniform_gnp", "kronecker", "grid_road", "webgraph"]
