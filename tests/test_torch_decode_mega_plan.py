"""CPU check of the LM decode megakernel's plan (csrc/decode_mega.cu, kernel
row 11; ops/cuda/decode_mega.py: block_queue, unit_waits, unit_signal,
unit_accesses, reducer_accesses).

The kernel's blocks are all resident and walk fixed queues of work units; a
unit spins on ready counters until the tiles it reads are published.  This
file runs that plan on the CPU, block by block, with the blocks advancing in
adversarial orders (all of one block's runnable units before the next block's,
low blocks first or high blocks first, and one unit at a time in a shuffled
order), for grids of 132, 199 and 264 blocks, B 1 / 4 / 8 and lengths 1, 128
and 1407 at the 0.6B planner's full width, through two layers (the second
reuses every scratch region).  It asserts:
  * no deadlock: every block's queue runs to its end;
  * every scratch tile is produced exactly once a layer (the residual's
    column tiles twice: after o_proj and after down_proj), and every counter
    ends at the count its waits expect;
  * no region is overwritten while a unit that reads its current contents is
    still pending, and every read sees the contents its layer and stage
    need (the last write before it in (layer, stage) order).
Two planted faults must each be caught: a queue order in which a block waits
for a tile that only a later unit of its own queue produces (deadlock), and
the softmax units' wait dropped (a read of contents not yet written).
"""

import bisect
import functools
import random
from collections import Counter, defaultdict

import pytest

from acestep_tpu_torch.ops.cuda import decode_mega as tm

N_LAYERS = 2
WIDTH = dict(h=1024, hq=16, hkv=8, inter=3072, t_max=1408)
LENGTHS = {1: [(1,), (128,), (1407,)],
           4: [(1, 128, 1407, 600)],
           8: [(1, 128, 1407, 129, 1000, 640, 1406, 2)]}
CASES = [(grid, b, lengths) for grid in (132, 199, 264) for b, ls in LENGTHS.items()
         for lengths in ls]
ORDERS = ("forward", "reverse", "shuffled")


class Deadlock(Exception):
    pass


class Hazard(Exception):
    pass


@functools.lru_cache(maxsize=None)
def _static(b, lengths):
    """The plan's every unit, each region key's writers in (layer, stage)
    order and how many reads each written version gets.  The last block of
    an o_proj / down_proj tile reduces after its stage's units: at stage +
    0.5."""
    plan = tm.mega_plan(b, **WIDTH)
    units = [(li, s, u) for li in range(N_LAYERS) for s, n in enumerate(plan.units)
             for u in range(n) if tm.unit_valid(plan, s, u, lengths)]
    accesses = []                  # ((layer, stage), reads, writes)
    for li, s, u in units:
        accesses.append(((li, s), *tm.unit_accesses(plan, li, s, u, lengths)))
    for li in range(N_LAYERS):
        for s in (3, 5):
            for ct in range(plan.n_h):
                accesses.append(((li, s + 0.5), *tm.reducer_accesses(plan, li, s, ct)))
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


def simulate(grid, b, lengths, order, queues=None, waits=tm.unit_waits, seed=0):
    """Run the plan; raises Deadlock or Hazard, else returns (counters,
    writes per (key, layer))."""
    plan, writers, expected = _static(b, lengths)
    if queues is None:
        queues = [tm.block_queue(plan, j, grid, lengths, N_LAYERS) for j in range(grid)]
    pos = [0] * grid
    counters = Counter()
    version = Counter()
    reads_done = Counter()
    produced = Counter()

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
            produced[key, at[0]] += 1

    def runnable(j):
        li, s, u = queues[j][pos[j]]
        return all(counters[g, i] >= t for g, i, t in waits(plan, li, s, u, lengths))

    def run(item):
        li, s, u = item
        reads, writes = tm.unit_accesses(plan, li, s, u, lengths)
        read(reads, (li, s))
        write(writes, (li, s))
        g, i = tm.unit_signal(plan, s, u)
        counters[g, i] += 1
        if g in ("t_o", "t_dn") and counters[g, i] == (plan.nk4 if g == "t_o" else plan.nk6):
            counters[g, i] = 0                       # the last block: the tile's reduction
            reads, writes = tm.reducer_accesses(plan, li, s, i)
            read(reads, (li, s + 0.5))
            write(writes, (li, s + 0.5))
            counters["r_o" if g == "t_o" else "r_dn", i] += 1

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
                run(queues[j][pos[j]])
                pos[j] += 1
                progress = True
                if order == "shuffled":
                    break
        if all(pos[j] == len(queues[j]) for j in range(grid)):
            return plan, counters, produced
        if not progress:
            stuck = [(j, queues[j][pos[j]]) for j in range(grid) if pos[j] < len(queues[j])]
            raise Deadlock(f"{len(stuck)} blocks wait forever, e.g. {stuck[:3]}")


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid,b,lengths", CASES,
                         ids=[f"g{g}-b{b}-{'_'.join(map(str, ls))}" for g, b, ls in CASES])
def test_plan_runs_without_deadlock_or_hazard(grid, b, lengths, order):
    plan, counters, produced = simulate(grid, b, lengths, order)
    _, writers, _ = _static(b, lengths)
    for key in writers:
        for li in range(N_LAYERS):
            assert produced[key, li] == (2 if key[0] == "x" else 1), (key, li)
    chunks = [max(1, -(-n // 128)) for n in lengths]
    want = {("c_qkv", t): N_LAYERS * plan.nk1 for t in range(plan.n_qkv)}
    want.update({("c_gu", t): N_LAYERS * plan.nk1 for t in range(plan.n_gu)})
    for bi in range(b):
        for h in range(plan.hkv):
            want["c_s2", bi * plan.hkv + h] = want["c_s3", bi * plan.hkv + h] = \
                N_LAYERS * chunks[bi]
    for t in range(plan.n_h):
        want["r_o", t] = want["r_dn", t] = N_LAYERS
        want["t_o", t] = want["t_dn", t] = 0
    assert {k: counters[k] for k in want} == want


def test_planted_deadlock_is_caught():
    """Block 0 runs its first scores unit (which waits for q head 0's qkv
    tile, all K chunks) before its first qkv unit (K chunk 0 of that tile)."""
    grid, b, lengths = 132, 1, (128,)
    plan, _, _ = _static(b, lengths)
    queues = [tm.block_queue(plan, j, grid, lengths, N_LAYERS) for j in range(grid)]
    q0 = queues[0]
    i_qkv, i_scores = q0.index((0, 0, 0)), q0.index((0, 1, 0))
    q0.insert(i_scores, q0.pop(i_qkv))
    with pytest.raises(Deadlock):
        simulate(grid, b, lengths, "forward", queues=queues)
    simulate(grid, b, lengths, "forward")            # the kernel's own order runs


def test_planted_missing_wait_is_caught():
    """The softmax units without their wait for the chunks' scores read
    contents that are not written yet."""
    def waits(plan, li, s, u, lengths):
        return [] if s == 2 else tm.unit_waits(plan, li, s, u, lengths)

    with pytest.raises(Hazard):
        simulate(132, 4, LENGTHS[4][0], "forward", waits=waits)


def test_plan_layout_and_gate():
    """The regions and sync words are disjoint and in the kernel's order;
    the gate's scratch bound follows the plan."""
    plan = tm.mega_plan(8, **WIDTH)
    assert len(plan.regions) == len(tm.REGIONS) + 1 and len(plan.groups) == len(tm.GROUPS) + 1
    assert all(b - a >= 0 and a % 4 == 0 for a, b in zip(plan.regions, plan.regions[1:]))
    assert plan.groups[-1] == (plan.n_qkv + 2 * 8 * plan.hkv + 4 * plan.n_h + plan.n_gu + 1)
    assert plan.units == (32 * 8, 8 * 8 * 11, 8 * 8 * 11, 8 * 16, 48 * 8, 8 * 24)
    assert tm.scratch_floats(8, 1024, 16, 8, 3072, 1408) == plan.regions[-1]
    queue = tm.block_queue(plan, 5, 264, [1] * 8, 1)
    assert queue == sorted(queue, key=lambda it: (it[0], it[1]))      # stage order
    assert all(u % 264 == 5 for _, _, u in queue)
