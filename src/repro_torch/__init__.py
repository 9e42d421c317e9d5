"""PyTorch / CUDA port of the phased-SSSP engine (NVIDIA Hopper).

A second package beside ``repro`` (the JAX reference), laid out like it:
``core`` (graph, criteria plans, phase policy, the resumable stepper),
``kernels`` (hand-written CUDA kernels for ``sm_90a`` plus their plain
PyTorch twins), ``graphs`` (the seeded numpy generators) and ``serving``
(the engine backend adapter). Every entry point takes ``device=None``,
which means the CUDA card, and raises when no card is present; pass
``device="cpu"`` to run the plain twins on the host (the tests do).

Only the default plan (``instatic|outstatic``, padded incoming ELL, no
targets, no telemetry) is ported so far; other modes raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
