"""PyTorch / CUDA port of the phased-SSSP engine (NVIDIA Hopper).

A second package beside ``repro`` (the JAX reference), laid out like it:
``core`` (graph, criteria, the phase policies, the resumable stepper and
the reference solvers), ``kernels`` (hand-written CUDA kernels for
``sm_90a`` plus their plain PyTorch twins, and the tuning ledger),
``graphs`` (the seeded numpy generators), ``serving`` (the engine
backends and the measured engine portfolio, the continuous batcher, point
queries, fault injection and the verified ``ResilientBatcher``) and
``obs`` (metrics, tracing, telemetry decoding, and the ``python -m
repro_torch.obs`` command line). Every entry point takes ``device=None``,
which means the CUDA card, and raises when no card is present; pass
``device="cpu"`` (or a graph built on the CPU, where the serving layer
follows its graph) to run the plain twins on the host (the tests do).

The stepper runs every mode of the reference's: every criterion plan, the
oracle plans included, delta-stepping, targets and the telemetry rings,
on the padded and the degree-sliced layouts; ``core.distributed`` shards
it over a ``torch.distributed`` group. ``configs`` and ``models`` hold the
LM substrate (the ten architectures; ``prefill``, ``decode_step``,
``forward_logits``, ``train_loss``), and ``optim``, ``data``,
``checkpoint``, ``runtime`` and ``launch.train`` its training on one
device; its mesh pieces are not ported yet (ROADMAP Queue 1).
"""
