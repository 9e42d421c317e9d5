"""PyTorch / CUDA port of the phased-SSSP engine (NVIDIA Hopper).

A second package beside ``repro`` (the JAX reference), laid out like it:
``core`` (graph, criteria, the phase policies, the resumable stepper and
the reference solvers), ``kernels`` (hand-written CUDA kernels for
``sm_90a`` plus their plain PyTorch twins), ``graphs`` (the seeded numpy
generators), ``serving`` (the engine backend, the continuous batcher and
point queries) and ``obs`` (metrics, tracing, telemetry decoding). Every
entry point takes ``device=None``, which means the CUDA card, and raises
when no card is present; pass ``device="cpu"`` to run the plain twins on
the host (the tests do).

The stepper runs every mode of the reference's: every criterion plan, the
oracle plans included, delta-stepping, targets and the telemetry rings,
on the padded and the degree-sliced layouts. The portfolio, fault and
resilience tiers, the execution config, the CLI, the sharded stepper and
the LM substrate are not ported yet (ROADMAP Queue 1).
"""
