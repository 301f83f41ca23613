"""The work split of the Hopper scatter-add kernel (K3,
paddle_tpu_torch/csrc/embedding_scatter_add.cu), emulated in PyTorch on
the CPU: the stable sort, the row offsets written from head flags, the
list of long segments, which long block and column slice take each long
segment, the rows the row blocks write (zeros for a row with no id), and
the order of each column's adds.  The emulation takes the kernel's
constants from its source, and is checked three ways: bit-equal to
``scatter_add_rows_plain`` (float32 and bf16), every output element
written exactly once, and a control that adds a long segment in chunks
(partial sums) falling outside.  Also the wrapper's scratch size against
the kernel's layout of it."""
import math
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops.cuda import embedding
from paddle_tpu_torch.ops.cuda.embedding import _scratch_ints, scatter_add_rows_plain

from _torch_validate import _no_port_validate_findings  # noqa: F401

SRC = (Path(embedding.__file__).resolve().parents[2] / "csrc" / "embedding_scatter_add.cu").read_text()
SMS = 132   # an H100's SMs: the host sizes the long blocks from it


def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, f"{name} not found in the kernel's source"
    return int(m.group(1))


K = {name: _const(name) for name in ("kSortThreads", "kRounds", "kLong", "kThreads",
                                     "kMinSliceBytes", "kLongItems", "kMaxItems")}
K["kProducers"] = K["kThreads"] - 32


def slice_cols(n_long, d, elem):
    """The columns of a long work item (slice_cols in the kernel)."""
    cols = 32
    while cols * elem > K["kMinSliceBytes"] and n_long * -(-d // cols) < K["kLongItems"]:
        cols //= 2
    return cols


def rows_per_stage(cols, elem, vec):
    """Rows a stage of a long block's ring holds: kCopies copies of a
    producer thread, 16 bytes each (vec) or an element."""
    copies, piece = (2, 16) if vec else (8, elem)
    return copies * K["kProducers"] * piece // elem // cols


def plan(v, d, ids, dtype, list_order=None, vec=True):
    """The kernel's plan for ids [n] into a [v, d] table: sorted (id, n)
    pairs, start[v + 1], the long segments' ids (in ``list_order``, a
    permutation: the kernel appends them by atomics), the long work items
    each long block takes, and the rows each row warp writes."""
    n = len(ids)
    valid = (ids >= 0) & (ids < v)
    pos = torch.nonzero(valid).flatten()
    keys, order = torch.sort(ids[valid].long(), stable=True)
    idx = pos[order]
    m = len(keys)
    # head flags: place p writes p for the rows (keys[p - 1], keys[p]]
    start = torch.full((v + 1,), -1, dtype=torch.long)
    writes = torch.zeros(v + 1, dtype=torch.long)
    longs = []
    for p in range(m + 1):
        prev = int(keys[p - 1]) if p > 0 else -1
        cur = int(keys[p]) if p < m else v
        start[prev + 1:cur + 1] = p
        writes[prev + 1:cur + 1] += 1
        if p < m and prev != cur and p + K["kLong"] < m and int(keys[p + K["kLong"]]) == cur:
            longs.append(cur)
    assert torch.all(writes == 1), "every offset written once"
    if list_order is not None:
        longs = [longs[i] for i in list_order(len(longs))]
    elem = torch.tensor([], dtype=dtype).element_size()
    cols = slice_cols(len(longs), d, elem)
    slices = -(-d // cols)
    items = len(longs) * slices
    min_cols = K["kMinSliceBytes"] // elem
    max_items = n // (K["kLong"] + 1) * -(-d // min_cols)
    blocks = -(-max_items // K["kMaxItems"])
    if blocks < 4 * SMS:
        blocks = min(4 * SMS, max_items)
    taken = {b: [(longs[it // slices], it % slices * cols) for it in range(b, items, blocks)]
             for b in range(blocks)}
    return dict(keys=keys, idx=idx, start=start, longs=longs, cols=cols, slices=slices,
                blocks=taken, rows_per_stage=rows_per_stage(cols, elem, vec))


def run_plan(v, d, ids, rows, p, chunked=False):
    """The output the plan writes, float32 sums in the kernel's order, and
    how often each element is written.  ``chunked``: the control, where a
    long segment is added a stage at a time from zero and the stage sums
    are then added (partial sums, which the kernel does not do)."""
    out = torch.zeros(v, d, dtype=torch.float32)
    written = torch.zeros(v, d, dtype=torch.long)
    rows32 = rows.float()
    start, idx = p["start"], p["idx"]
    longs = set(p["longs"])
    # row blocks: every row that is not long, its ids in sorted order
    for r in range(v):
        lo, hi = int(start[r]), int(start[r + 1])
        if hi - lo > K["kLong"]:
            assert r in longs
            continue
        acc = torch.zeros(d)
        for q in range(lo, hi):
            acc = acc + rows32[idx[q]]
        out[r] = acc
        written[r] += 1
    # long blocks: each item a slice of one long segment, a lane a column
    for items in p["blocks"].values():
        assert len(items) <= K["kMaxItems"]
        for key, c0 in items:
            lo, hi = int(start[key]), int(start[key + 1])
            c1 = min(c0 + p["cols"], d)
            acc = torch.zeros(c1 - c0)
            for base in range(lo, hi, p["rows_per_stage"]):
                stage = range(base, min(base + p["rows_per_stage"], hi))
                if chunked:
                    part = torch.zeros(c1 - c0)
                    for q in stage:
                        part = part + rows32[idx[q], c0:c1]
                    acc = acc + part
                else:
                    for q in stage:
                        acc = acc + rows32[idx[q], c0:c1]
            out[key, c0:c1] = acc
            written[key, c0:c1] += 1
    return out.to(rows.dtype), written


def _ids(v, n, kind, g):
    if kind == "all equal":
        return torch.full((n,), 7, dtype=torch.int32)
    if kind == "padding":
        ids = torch.randint(1, v, (n,), generator=g, dtype=torch.int32)
        ids[torch.rand(n, generator=g) < 0.25] = 0
        return ids
    if kind == "positions":
        return torch.arange(v, dtype=torch.int32).repeat(n // v)
    if kind == "two long":
        return torch.randint(5, 7, (n,), generator=g, dtype=torch.int32)
    if kind == "lengths":   # segments about the boundaries: 32 and 33 ids, a stage's rows +- 1
        lens = [32, 33, 55, 56, 57, 111, 112, 113, 223, 224, 225]
        ids = torch.cat([torch.full((k,), 2 * i + 1, dtype=torch.int32) for i, k in enumerate(lens)])
        return ids[torch.randperm(len(ids), generator=g)]
    if kind == "out of range":
        return torch.randint(-v, 2 * v, (n,), generator=g, dtype=torch.int32)
    return torch.randint(-2, v + 2, (n,), generator=g, dtype=torch.int32)


# the kinds of tests/test_torch_gpu.py's bit-equality cases, at small sizes
CASES = [
    (100, 36, 500, "random"),          # ragged D
    (410, 16, 900, "random"),
    (7000, 8, 900, "random"),          # two radix passes
    (30, 16, 600, "all equal"),        # one segment of every id
    (410, 16, 900, "padding"),         # a quarter of the ids 0: one long segment
    (16, 36, 1600, "random"),          # ~100 ids a row: every segment long
    (33, 130, 0, "random"),            # no ids: every row written as zeros
    (64, 16, 2048, "positions"),       # the position table's ids, tiled
    (16, 130, 700, "two long"),        # two long segments side by side
    (32, 16, 0, "lengths"),
    (64, 64, 1600, "out of range")]


def _rows(n, d, g, dtype):
    """Rows of mixed magnitude, so that another order of addition shows."""
    return (torch.randn(n, d, generator=g) * torch.exp(3 * torch.randn(n, 1, generator=g))).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("v,d,n,kind", CASES)
def test_plan_is_bit_equal_to_plain_and_writes_each_element_once(v, d, n, kind, dtype):
    g = torch.Generator().manual_seed(v + d + n)
    ids = _ids(v, n, kind, g)
    rows = _rows(len(ids), d, g, dtype)
    vec = d * rows.element_size() % 16 == 0
    p = plan(v, d, ids, dtype, vec=vec)
    valid = ids[(ids >= 0) & (ids < v)].long()
    assert torch.equal(p["start"], torch.searchsorted(p["keys"], torch.arange(v + 1)))
    assert sorted(p["longs"]) == sorted(int(k) for k in torch.unique(valid)
                                        if int((valid == k).sum()) > K["kLong"])
    got, written = run_plan(v, d, ids, rows, p)
    assert torch.all(written == 1), "every output element written exactly once"
    want = scatter_add_rows_plain(torch.empty(v, d, dtype=dtype), ids, rows)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_plan_does_not_depend_on_the_long_lists_order():
    """The kernel appends long segments by integer atomics, in an order that
    varies: another order moves items between blocks, never a sum."""
    g = torch.Generator().manual_seed(3)
    v, d = 24, 40
    ids = torch.randint(0, v, (2400,), generator=g, dtype=torch.int32)
    rows = _rows(len(ids), d, g, torch.float32)
    a = plan(v, d, ids, torch.float32)
    b = plan(v, d, ids, torch.float32, list_order=lambda k: list(reversed(range(k))))
    assert len(a["longs"]) == v and a["blocks"] != b["blocks"]
    assert torch.equal(run_plan(v, d, ids, rows, a)[0], run_plan(v, d, ids, rows, b)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_chunked_long_segment_control_is_not_bit_equal(dtype):
    """Partial sums of a stage each, then added, change the last bits of a
    long segment's float32 sum: the order of addition the gate holds is
    real.  (For bf16 rows the float32 sums are compared before the one
    rounding, which hides most float32 differences.)"""
    g = torch.Generator().manual_seed(11)
    v, d, n = 8, 64, 3000
    ids = torch.zeros(n, dtype=torch.int32)   # one segment of 3000 ids: many stages
    rows = _rows(n, d, g, dtype)
    p = plan(v, d, ids, dtype)
    want32 = scatter_add_rows_plain(torch.empty(v, d), ids, rows.float())
    ordered, _ = run_plan(v, d, ids, rows.float(), p)
    chunked, _ = run_plan(v, d, ids, rows.float(), p, chunked=True)
    assert torch.equal(ordered, want32)
    assert not torch.equal(chunked, want32)
    assert torch.equal(ordered.to(dtype), scatter_add_rows_plain(torch.empty(v, d, dtype=dtype),
                                                                 ids, rows))


def test_slices_narrow_when_long_segments_are_few():
    """The padding segment alone at D = 512: 32-byte slices, 16 bf16 or 8
    float32 columns (32 or 64 items); the position table's 256 segments:
    a lane a column."""
    assert slice_cols(1, 512, 2) == 16 and slice_cols(1, 512, 4) == 8
    assert slice_cols(256, 512, 2) == 32 and slice_cols(256, 512, 4) == 32
    for cols, elem in ((32, 2), (16, 2), (32, 4), (16, 4), (8, 4)):
        for vec in (True, False):
            assert rows_per_stage(cols, elem, vec) in (56, 112, 224)


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 2047, 2048, 2049])
def test_scratch_holds_the_kernels_layout(n):
    """The wrapper's scratch is the kernel's regions end to end: two key and
    two index arrays of n, a [tiles, 256] histogram over tiles of
    kSortThreads * kRounds ids, the counts of valid ids and of long
    segments, v + 1 offsets, and room for the most long segments n ids can
    make (each holds more than kLong)."""
    tile = K["kSortThreads"] * K["kRounds"]
    assert tile == embedding._SORT_TILE and K["kLong"] == embedding._LONG
    for v in (1, 256, 32000):
        regions = [4 * n, 256 * math.ceil(n / tile), 2, v + 1, n // (K["kLong"] + 1)]
        assert _scratch_ints(n, v) == sum(regions)
    if n:
        # the most long segments n ids make: n // (kLong + 1) of kLong + 1 ids
        most = n // (K["kLong"] + 1)
        ids = torch.arange(max(most, 1), dtype=torch.int32).repeat_interleave(K["kLong"] + 1)[:n]
        assert len(plan(max(most, 1), 8, ids, torch.float32)["longs"]) <= n // (K["kLong"] + 1)
