"""The port's entry points: one module for each script of the reference's
``examples/``, under the same names, each run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

Each takes the reference script's arguments and defaults plus
``--device`` (default: the CUDA card, raising without one; ``cpu`` runs
the plain twins on the host) and prints the reference script's lines with
the same fields in the same order, so one parser reads the output of
both; only the times differ. Each exposes ``main(argv=None)``, which
returns a :class:`Record` of what it printed beside the figures a caller
reads (phases, times, queries/s, the views built), so tests and
``chip_smoke.py`` call it in their own process. The modules import
``torch``, numpy, scipy and ``repro_torch`` only.

- ``quickstart``: ``run_phased`` under six criteria, the oracle plan and
  delta-stepping on G(2000, 10/n);
- ``sssp_pipeline``: four graph families through four engines against
  sequential Dijkstra; builds the padded in-view where it fits in a
  quarter of the device's free memory, else the degree-sliced one;
- ``batch_serving``: batches of sources on a road grid through
  ``run_phased_static_batch``;
- ``continuous_serving``: ``ContinuousBatcher`` (or, under ``--chaos``,
  ``ResilientBatcher`` behind a seeded fault plan) on a road grid, every
  answer against a solo solve; ``--trace`` / ``--report`` for the
  observability layer;
- ``distributed_serving``: the batcher over ``ShardedBackend`` in a
  ``torch.distributed`` world (under ``torchrun``, or ``--ranks`` gloo
  ranks it starts itself);
- ``serve_lm``: prefill and greedy decode of an LM;
- ``train_lm``: ``runtime.train_loop.train`` on the host mesh of the
  ranks present (a world of one when run plainly).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Record:
    """What an entry point printed (``lines``, in order) and the figures
    behind them (``fields``: name -> value, set by the script)."""

    lines: list[str] = dataclasses.field(default_factory=list)
    fields: dict = dataclasses.field(default_factory=dict)

    def say(self, text: str = "") -> None:
        """Print ``text`` (one or more lines) and keep it."""
        print(text, flush=True)
        self.lines.extend(text.split("\n"))


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu (the plain "
                         "twins on the host)")


def tensor_bytes(*views) -> int:
    """Bytes of every tensor in ``views`` (tuples of tensors, nested): the
    device memory an adjacency view holds."""
    total = 0
    for v in views:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, tuple):
            total += tensor_bytes(*v)
    return total


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a host clock reads device time
    only after it)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
