"""CPU check of the DiT Euler-step megakernel's plan (csrc/dit_mega.cu, kernel
row 12; ops/cuda/dit_mega.py: block_queue, unit_waits, unit_signal,
unit_accesses, DitPlan.k_ranges).

The kernel's blocks are all resident and walk fixed queues of work units; a
unit spins on ready counters until what it reads is published, and a GEMM
job's cluster blocks meet twice (after their partial tiles are parked,
and after each has summed its share of them).  This file runs that plan on
the CPU, block by block, with the blocks advancing in adversarial orders (all
of one block's runnable items before the next block's, low blocks first or
high blocks first, and one item at a time in a shuffled order), for grids of
132, 199 and 264 blocks (199: the last block belongs to no cluster and takes
no GEMM job), T in {8, 40, 128, 256} and Lc in {40, 320} at the full
width (H 2048, 16 / 8 heads of 128, I 6144), through two layers (the second
reuses every scratch region).  It asserts:
  * no deadlock: every block's queue runs to its end;
  * every scratch tile is produced exactly once a layer and stage (the
    residual's tiles three times: after o_proj, cross o_proj and down), and
    every counter ends at the count its waits expect;
  * no region is overwritten while a unit that reads its current contents is
    still pending, and every read sees the contents its layer and stage need
    (the last write before it in (layer, stage) order);
  * the split-K order of every output value is fixed: each GEMM's K ranges
    by cluster rank depend on the shapes only, never on the grid or on which
    cluster runs the job, and cover K once, in order.
Two planted faults must each be caught: a queue in which a block runs a
self-attention unit before the qkv job whose head it reads (deadlock), and
the cross-attention units' wait dropped (a read of contents not yet written).
"""

import bisect
import functools
import random
from collections import Counter, defaultdict

import pytest

from acestep_tpu_torch.ops.cuda import dit_mega as tm

N_LAYERS = 2
WIDTH = dict(h=2048, hq=16, hkv=8, inter=6144)
GRIDS = (132, 199, 264)
SHAPES = [(t, lc) for t in (8, 40, 128, 256) for lc in (40, 320)]
ORDERS = ("forward", "reverse", "shuffled")
CASES = [(grid, t, lc, ORDERS[i % 3]) for i, (grid, (t, lc)) in
         enumerate((g, s) for g in GRIDS for s in SHAPES)]


class Deadlock(Exception):
    pass


class Hazard(Exception):
    pass


def _at(li, s, phase):
    """Order of an access: a GEMM job's epilogue writes after its stage's
    accumulations read."""
    return (li, s + (0.5 if phase == tm.RED else 0.0))


@functools.lru_cache(maxsize=None)
def _static(t, grid):
    """The plan, each region key's writers in order and how many reads each
    written version gets, over every item of every block."""
    plan = tm.dit_plan(t, grid=grid, **WIDTH)
    accesses = []
    for b in range(grid):
        rank = b % tm.CS
        for li, s, u, p, ph in tm.block_queue(plan, b, N_LAYERS):
            reads, writes = tm.unit_accesses(plan, li, s, u, p, ph, rank)
            accesses.append((_at(li, s, ph), reads, writes))
    writers = defaultdict(list)
    for at, _, writes in accesses:
        for key in writes:
            writers[key].append(at)
    for w in writers.values():
        w.sort()
    expected = Counter()
    for at, reads, _ in accesses:
        for key in reads:
            v = bisect.bisect_left(writers[key], at)
            assert v > 0, f"{key} read at {at} before any write"
            expected[key, v] += 1
    return plan, dict(writers), expected


def simulate(grid, t, order, queues=None, waits=tm.unit_waits, seed=0):
    """Run the plan; raises Deadlock or Hazard, else returns (plan, counters,
    writes per (key, layer, stage))."""
    plan, writers, expected = _static(t, grid)
    if queues is None:
        queues = [tm.block_queue(plan, j, N_LAYERS) for j in range(grid)]
    pos = [0] * grid
    counters = Counter()
    version = Counter()
    reads_done = Counter()
    produced = Counter()
    phase_done = Counter()             # (layer, stage, job, pass, phase) -> ranks done

    def read(keys, at):
        for key in keys:
            v = bisect.bisect_left(writers[key], at)
            if version[key] != v:
                raise Hazard(f"{key} read at {at} holds version {version[key]}, needs {v}")
            reads_done[key, v] += 1

    def write(keys, at):
        for key in keys:
            v = version[key]
            if v and reads_done[key, v] != expected[key, v]:
                pending = expected[key, v] - reads_done[key, v]
                raise Hazard(f"{key} overwritten at {at} with {pending} readers of its contents "
                             "pending")
            if writers[key][v] != at:
                raise Hazard(f"{key} written out of order at {at}")
            version[key] += 1
            produced[key, at] += 1

    def runnable(j):
        li, s, u, p, ph = queues[j][pos[j]]
        if ph == tm.RED:               # the cluster's first meeting: every partial parked
            return phase_done[li, s, u, p, tm.ACC] == tm.CS
        if ph == tm.SYNC:              # the second: every share summed
            return phase_done[li, s, u, p, tm.RED] == tm.CS
        return all(counters[g, i] >= n for g, i, n in waits(plan, li, s, u, j % tm.CS))

    def run(j):
        li, s, u, p, ph = queues[j][pos[j]]
        reads, writes = tm.unit_accesses(plan, li, s, u, p, ph, j % tm.CS)
        at = _at(li, s, ph)
        read(reads, at)
        write(writes, at)
        if s in tm.GEMMS:
            phase_done[li, s, u, p, ph] += 1
        sig = tm.unit_signal(plan, s, u, ph)
        if sig is not None:
            counters[sig] += 1

    rng = random.Random(seed)
    blocks = list(range(grid))
    while True:
        if order == "reverse":
            blocks = list(range(grid - 1, -1, -1))
        elif order == "shuffled":
            rng.shuffle(blocks)
        progress = False
        for j in blocks:
            while pos[j] < len(queues[j]) and runnable(j):
                run(j)
                pos[j] += 1
                progress = True
                if order == "shuffled":
                    break
        if all(pos[j] == len(queues[j]) for j in range(grid)):
            return plan, counters, produced
        if not progress:
            stuck = [(j, queues[j][pos[j]]) for j in range(grid) if pos[j] < len(queues[j])]
            raise Deadlock(f"{len(stuck)} blocks wait forever, e.g. {stuck[:3]}")


@pytest.mark.parametrize("grid,t,lc,order", CASES,
                         ids=[f"g{g}-t{t}-lc{lc}-{o}" for g, t, lc, o in CASES])
def test_plan_runs_without_deadlock_or_hazard(grid, t, lc, order):
    """(Lc sizes no scratch and no unit: the cross K/V are the launch's
    inputs; the queues at both lengths are the same.)"""
    plan, counters, produced = simulate(grid, t, order)
    _, writers, _ = _static(t, grid)
    stages = defaultdict(list)
    for (key, at), n in produced.items():
        assert n == 1, (key, at)
        stages[key, at[0]].append(at)
    for key in writers:
        for li in range(N_LAYERS):
            assert len(stages[key, li]) == (3 if key[0] == "x" else 1), (key, li)
    want = {("norm", k): N_LAYERS * plan.n_norm for k in range(3)}
    want.update({("qkv", i): N_LAYERS * tm.CS * plan.passes for i in range(plan.units(tm.QKV))})
    want.update({("cq", i): N_LAYERS * tm.CS * plan.passes for i in range(plan.units(tm.CQ))})
    for g in range(plan.hkv):
        want["self", g] = want["cross", g] = N_LAYERS * plan.pairs * plan.nqb
    for s, i in tm.RESID.items():
        want["resid", i] = N_LAYERS * plan.units(s) * tm.CS * plan.passes
    want["gu", 0] = N_LAYERS * plan.units(tm.GU) * tm.CS * plan.passes
    assert {k: counters[k] for k in want} == want


@pytest.mark.parametrize("t", [8, 40, 128, 256])
def test_split_k_order_is_fixed(t):
    """Each GEMM's K ranges by rank: the same at every grid, contiguous,
    covering K once; the 64-column stages' ranges even (alternate steps to
    the two warpgroups)."""
    for s in tm.GEMMS:
        ranges = {tm.dit_plan(t, grid=g, **WIDTH).k_ranges(s) for g in GRIDS}
        assert len(ranges) == 1, (s, ranges)
        (rs,) = ranges
        k, _ = tm.dit_plan(t, grid=132, **WIDTH).gemm(s)
        assert rs[0][0] == 0 and rs[-1][1] == -(-k // tm.KSTEP)
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
        if s not in tm.MODE_A:
            assert all((e - b) % 2 == 0 for b, e in rs[:-1])


def test_planted_deadlock_is_caught():
    """Block 0 runs its first self-attention unit (which waits for q head 0,
    the qkv job of its own cluster) before that job's accumulation."""
    grid, t = 132, 128
    plan, _, _ = _static(t, grid)
    queues = [tm.block_queue(plan, j, N_LAYERS) for j in range(grid)]
    q0 = queues[0]
    i_acc = q0.index((0, tm.QKV, 0, 0, tm.ACC))
    i_self = q0.index((0, tm.SELF, 0, 0, tm.UNIT))
    q0.insert(i_acc, q0.pop(i_self))
    with pytest.raises(Deadlock):
        simulate(grid, t, "forward", queues=queues)
    simulate(grid, t, "forward")                      # the kernel's own order runs


def test_planted_missing_wait_is_caught():
    """The cross-attention units without their wait for the cross-q tiles
    read contents that are not written yet."""
    def waits(plan, li, s, u, rank=0):
        return [] if s == tm.CROSS else tm.unit_waits(plan, li, s, u, rank)

    with pytest.raises(Hazard):
        simulate(132, 128, "forward", waits=waits)


def test_plan_layout():
    """Regions and sync words in the kernel's order, disjoint and aligned;
    the units of a full-width layer; a block's queue in stage order."""
    plan = tm.dit_plan(128, grid=132, **WIDTH)
    assert len(plan.regions) == len(tm.REGIONS) + 1 and len(plan.groups) == len(tm.GROUPS) + 1
    assert all(b >= a and a % 256 == 0 for a, b in zip(plan.regions, plan.regions[1:]))
    assert plan.groups[-1] == 3 + 32 + 8 + 32 + 8 + 3 + 1 + 1
    assert [plan.units(s) for s in range(len(tm.STAGES))] == \
        [16, 32, 64, 32, 16, 32, 64, 32, 16, 96, 32]
    queue = tm.block_queue(plan, 5, 1)
    assert queue == sorted(queue, key=lambda it: (it[0], it[1]))      # stage order
    assert tm.SMEM <= 232448
