"""The tensor-parallel collectives of ``sharding.comm`` and their gradient
rules, each against a single-process autograd of the whole function, in
a gloo world of 4 ranks as a (1, 4) mesh (one thread a rank, the harness
of ``test_torch_lm_mesh_common.py``):

  * ``gather_seq``: every rank's block joined, each rank's own work on the
    whole; the backward sums the ranks' gradients (reduce-scatter);
  * ``scatter_seq``: the partial sums' sum, this rank's block of it; the
    backward all-gathers;
  * ``sum_over``: the partial sums' replicated sum; the backward is the
    identity;
  * ``exchange``: the columns each rank's heads read, from the blocks that
    hold them (an all-to-all with split sizes, here a plan where ranks
    take from none, one or two others and one rank takes nothing); the
    backward sums every use onto the block, in a fixed order, so two runs
    give the same bits;
  * ``all_max`` and ``all_to_all_rows`` (no gradient).

Every rank's values and gradients are held to the whole function's within
1e-12 in f64 (the sums differ from one process's only in their order).
"""
import numpy as np
import torch
import torch.distributed as dist

from test_torch_lm_mesh_common import mesh_of, start_world

TP = 4
# (global columns each rank needs) over blocks of 3 columns: rank 0 reads
# its own and rank 1's first; rank 1 nothing; rank 2 all of rank 3's and
# two of rank 0's; rank 3 a column of its own twice over via two ranks
NEED = ((0, 1, 2, 3), (), (9, 10, 11, 0, 1), (11, 4))


def _whole(gen, *shape):
    return torch.randn(*shape, generator=gen, dtype=torch.float64)


def _close(a, b):
    return bool(torch.allclose(a, b, rtol=1e-12, atol=1e-12))


def _rules(rank, world, spec):
    from repro_torch.sharding import comm

    mesh = mesh_of(1, TP)
    m = mesh.coords["model"]
    gen = torch.Generator().manual_seed(5)
    x = _whole(gen, 2, 8, 3)  # (B, S, D): S over "model" in blocks of 2
    w = _whole(gen, TP, 2, 8, 3)  # rank r's own weights on the whole
    out = {}

    # gather_seq: each rank multiplies the whole by its own w[r]; the
    # whole function sums every rank's product
    xr = x.clone().requires_grad_()
    blk = xr[:, 2 * m:2 * m + 2]
    y = comm.gather_seq(mesh, "model", blk, 1) * w[m]
    total = comm.sum_over(mesh, "model", y.sum())
    (g,) = torch.autograd.grad(total, xr)
    want = w.sum(0)
    out["gather_seq"] = (_close(total, (x * want).sum()),
                         _close(g[:, 2 * m:2 * m + 2], want[:, 2 * m:2 * m + 2]),
                         _close(g.sum() - g[:, 2 * m:2 * m + 2].sum(),
                                torch.zeros((), dtype=torch.float64)))

    # scatter_seq: rank r's partial is x * w[r]; the block of the sum, then
    # a loss on every block (each rank's block weighted by r + 1)
    xr = x.clone().requires_grad_()
    part = xr * w[m]
    blk = comm.scatter_seq(mesh, "model", part, 1)
    loss = comm.sum_over(mesh, "model", (m + 1) * blk.sum())
    (g,) = torch.autograd.grad(loss, xr)
    scale = torch.arange(1, TP + 1, dtype=torch.float64).repeat_interleave(2)
    full = (x[None] * w).sum(0)
    out["scatter_seq"] = (
        _close(blk, full[:, 2 * m:2 * m + 2]),
        _close(g, w[m] * scale[None, :, None]),
        _close(loss, (full * scale[None, :, None]).sum()))

    # sum_over: the replicated sum of the partials; its gradient is the
    # whole gradient on every rank (the identity)
    xr = x.clone().requires_grad_()
    s = comm.sum_over(mesh, "model", xr * w[m])
    (g,) = torch.autograd.grad((s * s).sum(), xr)
    out["sum_over"] = (_close(s, full), _close(g, 2 * full * w[m]))

    # exchange: columns of a (5, 12) weight, blocks of 3 over "model";
    # each rank's loss weighs its columns by its own matrix
    wt = _whole(gen, 5, 4 * 3)
    r_w = [_whole(gen, 5, len(n)) for n in NEED]
    blk = wt[:, 3 * m:3 * m + 3].clone().requires_grad_()
    mine = comm.exchange(mesh, "model", blk, 1, NEED, "w")
    loss = comm.sum_over(mesh, "model", (mine * r_w[m]).sum())
    (g,) = torch.autograd.grad(loss, blk)
    want_g = torch.zeros_like(wt)
    for r, need in enumerate(NEED):
        for j, c in enumerate(need):
            want_g[:, c] += r_w[r][:, j]
    again = comm.exchange(mesh, "model", blk, 1, NEED, "w")
    (g2,) = torch.autograd.grad(
        comm.sum_over(mesh, "model", (again * r_w[m]).sum()), blk)
    out["exchange"] = (
        _close(mine, wt[:, list(NEED[m])]),
        _close(g, want_g[:, 3 * m:3 * m + 3]),
        torch.equal(g, g2))

    # all_max and all_to_all_rows, no gradient
    v = torch.tensor([float(m), -float(m)], dtype=torch.float64)
    out["all_max"] = torch.equal(comm.all_max(mesh, "model", v),
                                 torch.tensor([TP - 1.0, 0.0],
                                              dtype=torch.float64))
    # rank r sends j + 1 rows to rank j, each row (r, j)
    rows = torch.cat([torch.tensor([[m, j]] * (j + 1))
                      for j in range(TP)]).double()
    got = comm.all_to_all_rows(mesh, "model", rows,
                               [j + 1 for j in range(TP)], [m + 1] * TP)
    want = torch.cat([torch.tensor([[q, m]] * (m + 1))
                      for q in range(TP)]).double()
    out["all_to_all_rows"] = torch.equal(got, want)
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def test_tensor_parallel_rules_match_one_process_autograd(tmp_path):
    every = start_world(tmp_path, "tp-rules", TP, _rules)()
    for rank, out in enumerate(every):
        for rule, ok in out.items():
            assert np.all(ok), (rank, rule, ok)


def test_exchange_plan_sends_only_what_is_read():
    """The plan moves each needed column once from its block: what rank j
    sends rank r is what r needs from j's block, and the result's order
    is the need's."""
    from repro_torch.sharding.comm import exchange_plan

    for r in range(TP):
        own, send, recv, order = exchange_plan(TP, r, 3, NEED)
        assert own == tuple(c - 3 * r for c in NEED[r] if c // 3 == r)
        for j in range(TP):
            from_j = [c for c in NEED[r] if c // 3 == j and j != r]
            assert recv[j] == len(from_j)
            got = exchange_plan(TP, j, 3, NEED)[1][r]
            assert got == tuple(c - 3 * j for c in from_j)
        assert sorted(order) == list(range(len(NEED[r])))


def test_embed_block_form_is_the_whole_gradient_s_rows():
    """The vocabulary-parallel lookup (``EmbedLookup`` with ``row0``) on
    the CPU: each of 4 blocks of a 40-row table gives the whole table's
    rows where an id lies in the block and zeros elsewhere, and its
    gradient (``embed_grad``'s twin in its block form) is the block's rows
    of the whole table's gradient, bit for bit."""
    from repro_torch.kernels.embed_grad import EmbedLookup

    gen = torch.Generator().manual_seed(9)
    table = torch.randn(40, 6, generator=gen)
    ids = torch.randint(0, 40, (3, 17), generator=gen)
    g = torch.randn(3, 17, 6, generator=gen)
    whole = table.clone().requires_grad_()
    (want,) = torch.autograd.grad((EmbedLookup.apply(whole, ids) * g).sum(),
                                  whole)
    total = torch.zeros(3, 17, 6)
    for b in range(4):
        blk = table[10 * b:10 * b + 10].clone().requires_grad_()
        out = EmbedLookup.apply(blk, ids, 10 * b)
        inside = (ids >= 10 * b) & (ids < 10 * b + 10)
        assert torch.equal(out[~inside], torch.zeros_like(out[~inside]))
        total += out
        (got,) = torch.autograd.grad((out * g).sum(), blk)
        assert torch.equal(got, want[10 * b:10 * b + 10])
    assert torch.equal(total, table[ids])
