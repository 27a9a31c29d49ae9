"""The int8 tier's device chain as CUDA graphs (``search.Int8ScanGraphs``).

On the card (``cuda`` marker; skipped without one): a graphed call equals
the eager ``int8_scan_topk`` bit for bit at the 1M cell's shape and at a
shard's, across filters, after an in-place write, after a growth rebuild,
under two threads, on the 4-shard route (under two threads too), and for a
query count padded up to its bucket; the counters say one capture per card
and bucket, one replay per later call and card, one B2 run per call and
card, one merge (P2) per sharded call and none on one card, and no mix of
query counts and k captures more than one graph per bucket. On the
CPU: the int8 routes stay eager and capture nothing, and the buckets, the
cache's keys, eviction and drops, which do not depend on the device,
behave. No JAX here, so the card tests run on a machine with only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_graphs.py
"""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu_torch.gallery import schema
from retrieval_based_object_detection_tpu_torch.gallery import search
from retrieval_based_object_detection_tpu_torch.gallery import sharded
from retrieval_based_object_detection_tpu_torch.gallery import store
from retrieval_based_object_detection_tpu_torch.ops import cuda_lib
from retrieval_based_object_detection_tpu_torch.ops import int8_scan as S
from retrieval_based_object_detection_tpu_torch.ops import int8_select as SEL
from retrieval_based_object_detection_tpu_torch.ops import shard_merge as SM
from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
    make_mesh,
)
from retrieval_based_object_detection_tpu_torch.utils import (
    logging as tracer,
)

COUNTERS = ("search.int8.graph_captures", "search.int8.graph_replays")


@pytest.fixture
def cuda_device():
    # Decided here, not at import, so every test worker collects the same
    # tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _counts(since=(0, 0)) -> tuple[int, int]:
    """(captures, replays) since an earlier reading."""
    c = tracer.counters()
    return tuple(c.get(name, 0) - s for name, s in zip(COUNTERS, since))


def _rows(n, d, seed) -> np.ndarray:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g).numpy()


def _mirrors(n, d, seed, device):
    """(int8 [n, d], normalised f32 [n, d]) made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    f32 = search.l2_normalize(torch.randn(n, d, generator=g, device=device))
    return search.quantize_rows_int8(f32), f32


def _mask(n, share, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=g, device=device) < share


def _queries(f32, q, seed) -> np.ndarray:
    """Rows of the gallery plus noise, on the host."""
    g = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, f32.shape[0], (q,), generator=g)
    return (f32[pick.to(f32.device)].cpu()
            + 0.05 * torch.randn(q, f32.shape[1], generator=g)).numpy()


def _eager(q, gi8, gf32, mask, k=10, rescore=256):
    return search.int8_scan_topk(torch.from_numpy(q).to(gf32.device), gi8,
                                 gf32, mask, k=k, rescore=rescore)


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _payloads(n, classes=4):
    return [schema.Payload(data_type="original_images",
                           class_name=f"c{i % classes}") for i in range(n)]


# ------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_048_576, 1_179_648],
                         ids=["the-1M-cell", "a-shard"])
def test_graph_matches_the_eager_chain_bit_for_bit(cuda_device, n):
    """[16, n, 512], top-10 of 256 rescored: the capture's call and a
    replay equal the eager chain exactly; one capture, one replay, and B2
    runs once a call."""
    gi8, gf32 = _mirrors(n, 512, 1, cuda_device)
    mask = _mask(n, 0.5, 2, cuda_device)
    q = _queries(gf32, 16, 3)
    graphs = search.Int8ScanGraphs()
    before, b2 = _counts(), S.KERNEL.launches
    for _ in range(2):
        _assert_same(graphs.topk(q, gi8, gf32, mask, k=10, rescore=256),
                     _eager(q, gi8, gf32, mask))
    assert S.KERNEL.launches == b2 + 4  # two graphed calls, two eager
    assert _counts(before) == (1, 1)


@pytest.mark.cuda
def test_filters_change_without_a_new_capture(cuda_device):
    """Consecutive calls with other masks (most rows, 1%, none, five rows,
    and a view mask ANDed with a filter) replay the one graph and equal
    the eager chain on each mask."""
    n = 262_144
    gi8, gf32 = _mirrors(n, 512, 4, cuda_device)
    q = _queries(gf32, 16, 5)
    few = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    few[[3, 70_000, 140_000, 200_000, n - 1]] = True
    masks = [_mask(n, 0.9, 6, cuda_device), _mask(n, 0.01, 7, cuda_device),
             torch.zeros(n, dtype=torch.bool, device=cuda_device), few]
    graphs = search.Int8ScanGraphs()
    graphs.topk(q, gi8, gf32, masks[0], k=10)
    before = _counts()
    for m in masks:
        _assert_same(graphs.topk(q, gi8, gf32, m, k=10),
                     _eager(q, gi8, gf32, m))
    view, flt = _mask(n, 0.8, 8, cuda_device), _mask(n, 0.3, 9, cuda_device)
    _assert_same(graphs.topk(q, gi8, gf32, view & flt, k=10),
                 _eager(q, gi8, gf32, view & flt))
    assert _counts(before) == (0, len(masks) + 1)


@pytest.mark.cuda
def test_counters_one_capture_per_card_and_shape(cuda_device):
    """Four query counts (16, one, three and four; three and four share
    the bucket of four) on one gallery, three calls each: three captures,
    nine replays, three entries, twelve B2 runs."""
    g = store.Gallery("shapes", dim=128, device=cuda_device)
    rows = _rows(20_000, 128, 10)
    g.upsert([f"p{i}" for i in range(20_000)], rows, _payloads(20_000))
    before, b2 = _counts(), S.KERNEL.launches
    for _ in range(3):
        for q in (rows[:16], rows[16:17], rows[17:20], rows[20:24]):
            g.search(q, k=10, method="int8")
    assert _counts(before) == (3, 9)
    assert len(g._int8_graphs) == 3 and S.KERNEL.launches == b2 + 12


@pytest.mark.cuda
def test_a_padded_bucket_matches_the_eager_chain(cuda_device):
    """Three queries in the bucket of four, its fourth row left over from
    an earlier call of four: the rows of the three equal the eager chain's
    over the four bit for bit, and its rows over the three alone."""
    n = 262_144
    gi8, gf32 = _mirrors(n, 512, 26, cuda_device)
    mask = _mask(n, 0.7, 27, cuda_device)
    four = _queries(gf32, 4, 28)
    three = _queries(gf32, 3, 29)
    graphs = search.Int8ScanGraphs()
    _assert_same(graphs.topk(four, gi8, gf32, mask, k=10),
                 _eager(four, gi8, gf32, mask))
    before = _counts()
    got = graphs.topk(three, gi8, gf32, mask, k=10)
    assert _counts(before) == (0, 1)
    padded = np.concatenate([three, four[3:]])
    _assert_same(got, [t[:3] for t in _eager(padded, gi8, gf32, mask)])
    alone = _eager(three, gi8, gf32, mask)
    assert torch.equal(got[1], alone[1])
    torch.testing.assert_close(got[0], alone[0], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_mixed_shapes_capture_once_per_bucket(cuda_device):
    """120 calls with query counts of 1 to 64 and k of 1 to 32, as the
    REST search and the Qdrant façade pass them on: at most one capture per
    bucket, whatever the order, and every call's rows the eager chain's
    over its own queries; 65 queries, or k = 33 (264 candidates), run the
    eager chain and neither capture nor replay."""
    n = 131_072
    gi8, gf32 = _mirrors(n, 256, 30, cuda_device)
    mask = _mask(n, 0.8, 31, cuda_device)
    graphs = search.Int8ScanGraphs()
    rng = np.random.default_rng(32)
    before = _counts()
    for j in range(120):
        q = _queries(gf32, int(rng.integers(1, 65)), 33 + j)
        k = int(rng.integers(1, 33))
        got = graphs.topk(q, gi8, gf32, mask, k=k)
        want = _eager(q, gi8, gf32, mask, k=k)
        assert torch.equal(got[1], want[1]), j
        torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    captures, replays = _counts(before)
    assert captures == len(graphs) <= len(search.GRAPH_QUERIES)
    assert captures + replays == 120
    before = _counts()
    for q, k, rescore in ((_queries(gf32, 65, 200), 10, 256),
                          (_queries(gf32, 16, 201), 33, 264)):
        _assert_same(graphs.topk(q, gi8, gf32, mask, k=k, rescore=rescore),
                     _eager(q, gi8, gf32, mask, k=k, rescore=rescore))
    assert _counts(before) == (0, 0)


@pytest.mark.cuda
def test_an_in_place_write_is_seen_by_the_replay(cuda_device):
    """An overwrite and an append inside the padding patch the mirrors in
    place: the same graph, replayed, finds both new rows."""
    n, d = 4000, 64  # padded to 4,096
    rows = _rows(n, d, 11)
    g = store.Gallery("patch", dim=d, device=cuda_device)
    g.upsert([f"p{i}" for i in range(n)], rows, _payloads(n))
    q = rows[:4] + 0.1 * _rows(4, d, 12)
    g.search(q, k=5, method="int8")
    mirrors = (g._dev_int8, g._dev_f32)
    new = _rows(2, d, 13)
    g.upsert(["p7", "added"], new, _payloads(2))
    q[0], q[1] = new[0], new[1]
    before = _counts()
    hits = g.search(q, k=5, method="int8")
    assert [hits[0][0].id, hits[1][0].id] == ["p7", "added"]
    assert g._dev_int8 is mirrors[0] and g._dev_f32 is mirrors[1]
    assert _counts(before) == (0, 1)
    _assert_same(g._int8_graphs.topk(q, *mirrors, g._device_mask(None),
                                     k=5),
                 _eager(q, *mirrors, g._device_mask(None), k=5))


@pytest.mark.cuda
def test_a_growth_rebuild_captures_anew_and_frees_the_old(cuda_device):
    """An append past the padding rebuilds the mirrors: the next call
    captures again over the new ones, and the old entry's mirrors are
    freed."""
    n, d = 4096, 64
    rows = _rows(n + 1, d, 14)
    g = store.Gallery("grow", dim=d, device=cuda_device)
    g.upsert([f"p{i}" for i in range(n)], rows[:n], _payloads(n))
    q = rows[:4].copy()
    g.search(q, k=5, method="int8")
    old = [weakref.ref(t) for t in (g._dev_int8, g._dev_f32)]
    g.upsert(["last"], rows[n:], _payloads(1))
    q[3] = rows[n]
    before = _counts()
    hits = g.search(q, k=5, method="int8")
    assert hits[3][0].id == "last"
    assert _counts(before) == (1, 0) and len(g._int8_graphs) == 1
    assert g._padded == 8192
    gc.collect()
    assert all(ref() is None for ref in old)


@pytest.mark.cuda
def test_two_threads_search_at_once(cuda_device):
    """Two threads, each alternating two shapes and four filters on one
    gallery (so both graphs of the card's shared pool run interleaved),
    get what one thread got for the same calls."""
    n, d = 200_000, 128
    rows = _rows(n, d, 15)
    g = store.Gallery("threads", dim=d, device=cuda_device)
    g.upsert([f"p{i}" for i in range(n)], rows, _payloads(n))
    flts = [schema.Filter(must={"class_name": f"c{c}"}) for c in range(4)]
    calls = [(rows[16 * j: 16 * j + (16 if j % 2 else 3)]
              + 0.2 * _rows(16 if j % 2 else 3, d, 16 + j), flts[j % 4])
             for j in range(8)]

    def answer(q, flt):
        return [[(h.id, h.score) for h in hits]
                for hits in g.search(q, k=10, flt=flt, method="int8")]

    want = [answer(q, f) for q, f in calls]
    errors: list[str] = []

    def worker(offset):
        for j in range(200):
            c = (j + offset) % len(calls)
            if answer(*calls[c]) != want[c]:
                errors.append(f"call {c} differs")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(o,)) for o in (0, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(g._int8_graphs) == 2


def _four_cards() -> list[torch.device]:
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    return [torch.device(f"cuda:{i}") for i in range(4)]


def _match_the_eager_merge(devices):
    """The 4-shard route on a mesh of ``devices``, a filter ANDed with the
    view's mask: the merged top-10 equals the merge of the eager chain's
    per-shard top-10 exactly; four captures on the first call (one per
    shard), four replays each later call, four B2 and four candidate select
    runs every call, and one merge (P2) launch, counted once in
    ``search.sharded.merges``."""
    n, d, k = 600_000, 512, 10
    rows = _rows(n, d, 17)
    live = torch.rand(n, generator=torch.Generator().manual_seed(18)) > 0.1
    mesh = make_mesh({"gallery": 4}, devices)
    view = sharded.ShardedGallerySearcher(rows, live.numpy(), mesh)
    view.ensure_mirror("int8")
    q = rows[:16] + 0.3 * _rows(16, d, 19)
    rescore = min(max(8 * k, 256), view.rows_per)
    before = _counts()
    for j, share in enumerate((0.5, 0.05)):
        flt = (torch.rand(n, generator=torch.Generator().manual_seed(20 + j))
               < share).numpy()
        b2, p1, p2 = S.KERNEL.launches, SEL.KERNEL.launches, \
            SM.KERNEL.launches
        merges = tracer.counters().get("search.sharded.merges", 0)
        scores, idx = view.search(q, k=k, method="int8", extra_mask=flt)
        assert _counts(before) == (4, 4 * j) and S.KERNEL.launches == b2 + 4
        assert (SEL.KERNEL.launches - p1, SM.KERNEL.launches - p2) == (4, 1)
        assert tracer.counters()["search.sharded.merges"] == merges + 1
        fm = view.split_mask(flt)
        per = [_eager(q, view._dev_int8[s], view.dev_vectors[s],
                      view.dev_mask[s] & fm[s], k=k, rescore=rescore)
               for s in range(4)]
        ws, wi = sharded._gather_merge([p[0] for p in per],
                                       [p[1] for p in per], view.rows_per, k)
        np.testing.assert_array_equal(scores, ws.cpu().numpy())
        np.testing.assert_array_equal(idx, wi.cpu().numpy())
        assert (flt[idx] & view._host_mask[idx]).all()
    assert len(view._int8_graphs) == 4


@pytest.mark.cuda
def test_four_shards_on_one_card_match_the_eager_merge(cuda_device):
    _match_the_eager_merge([cuda_device] * 4)


@pytest.mark.cuda
def test_four_shards_on_four_cards_match_the_eager_merge(cuda_device):
    """As on one card, with the merge reading the other three cards'
    candidates over peer access (or copies) behind their streams."""
    _match_the_eager_merge(_four_cards())


@pytest.mark.cuda
def test_replays_count_one_select_launch_per_card_and_shard(cuda_device):
    """The candidate select runs once a chain: a single-card call (captured,
    then replayed) and the eager chain (k = 33) add one select launch and
    one B2 run each, and no merge; a 4-shard call adds four of each,
    captured or replayed, and one merge."""
    n, d = 300_000, 512
    rows = _rows(n, d, 40)
    gi8, gf32 = _mirrors(n, d, 41, cuda_device)
    mask = _mask(n, 0.6, 42, cuda_device)
    q = _queries(gf32, 16, 43)
    graphs = search.Int8ScanGraphs()
    for k, rescore in ((10, 256), (10, 256), (33, 264)):
        sel, b2, p2 = SEL.KERNEL.launches, S.KERNEL.launches, \
            SM.KERNEL.launches
        graphs.topk(q, gi8, gf32, mask, k=k, rescore=rescore)
        assert (SEL.KERNEL.launches - sel, S.KERNEL.launches - b2,
                SM.KERNEL.launches - p2) == (1, 1, 0)
    live = torch.rand(n, generator=torch.Generator().manual_seed(44)) > 0.1
    view = sharded.ShardedGallerySearcher(
        rows, live.numpy(), make_mesh({"gallery": 4}, [cuda_device] * 4))
    view.ensure_mirror("int8")
    for _ in range(3):
        sel, b2, p2 = SEL.KERNEL.launches, S.KERNEL.launches, \
            SM.KERNEL.launches
        view.search(rows[:16], k=10, method="int8")
        assert (SEL.KERNEL.launches - sel, S.KERNEL.launches - b2,
                SM.KERNEL.launches - p2) == (4, 4, 1)


def _two_threads_search_one_view(devices):
    """Two threads on one 4-shard view over ``devices``, each cycling two
    query counts and three filters: every call's answer is the one a lone
    caller got, although the merge reads each shard's graph outputs after
    all four replays. On one card, two buckets of four shards are eight
    graphs for the card's seven places, so captures come among the
    replays."""
    n, d = 400_000, 256
    rows = _rows(n, d, 50)
    live = torch.rand(n, generator=torch.Generator().manual_seed(51)) > 0.1
    view = sharded.ShardedGallerySearcher(
        rows, live.numpy(), make_mesh({"gallery": 4}, devices))
    view.ensure_mirror("int8")
    flts = [(torch.rand(n, generator=torch.Generator().manual_seed(52 + f))
             < share).numpy() for f, share in enumerate((0.9, 0.3, 0.02))]
    calls = [(rows[16 * j: 16 * j + (16 if j % 2 else 3)]
              + 0.2 * _rows(16 if j % 2 else 3, d, 60 + j), flts[j % 3])
             for j in range(6)]

    def answer(q, flt):
        return view.search(q, k=10, method="int8", extra_mask=flt)

    want = [answer(q, f) for q, f in calls]
    errors: list[str] = []

    def worker(offset):
        for j in range(150):
            c = (j + offset) % len(calls)
            got = answer(*calls[c])
            if not all(np.array_equal(a, b) for a, b in zip(got, want[c])):
                errors.append(f"call {c} differs")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(o,)) for o in (0, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]


@pytest.mark.cuda
def test_two_threads_search_one_sharded_view(cuda_device):
    _two_threads_search_one_view([cuda_device] * 4)


@pytest.mark.cuda
def test_two_threads_search_a_view_sharded_over_four_cards(cuda_device):
    _two_threads_search_one_view(_four_cards())


# ------------------------------------------------------------- the CPU


def test_cpu_int8_routes_stay_eager():
    """On CPU tensors the single-device and the sharded int8 routes run
    the eager chain: no capture, no replay, no entry, and the single
    route's hits are ``int8_scan_topk``'s."""
    n, d = 3000, 32
    rows = _rows(n, d, 21)
    g = store.Gallery("cpu", dim=d, device="cpu")
    g.upsert([f"p{i}" for i in range(n)], rows, _payloads(n))
    q = rows[:5] + 0.1 * _rows(5, d, 22)
    flt = schema.Filter(must={"class_name": "c1"})
    before = _counts()
    hits = g.search(q, k=7, flt=flt, method="int8")
    s, i = _eager(q, g._dev_int8, g._dev_f32, g._device_mask(flt), k=7)
    for got, srow, irow in zip(hits, s.numpy(), i.numpy()):
        assert [h.id for h in got] == [f"p{r}" for r in irow]
        assert [h.score for h in got] == srow.tolist()
    g.attach_mesh(make_mesh({"gallery": 4}, ["cpu"] * 4))
    sharded_hits = g.search(q, k=7, flt=flt, method="sharded_int8")
    assert [[h.id for h in r] for r in sharded_hits] == \
        [[h.id for h in r] for r in hits]
    assert _counts(before) == (0, 0)
    assert len(g._int8_graphs) == 0 and len(g._shard_view._int8_graphs) == 0


@pytest.mark.parametrize("q,bucket", [(1, 1), (2, 2), (3, 4), (5, 8),
                                      (16, 16), (17, 32), (64, 64),
                                      (65, None)])
def test_query_counts_fall_in_buckets(q, bucket):
    assert search.Int8ScanGraphs.bucket(q) == bucket


def test_key_names_the_card_the_bucket_and_the_mirrors():
    gi8, gf32 = _mirrors(512, 32, 23, torch.device("cpu"))
    key = search.Int8ScanGraphs.key
    base = key(16, gi8, gf32, 256)
    assert base == key(16, gi8, gf32, 256)
    other_i8, other_f32 = gi8.clone(), gf32.clone()
    for changed in (key(1, gi8, gf32, 256),
                    key(16, gi8, gf32, 128),
                    key(16, other_i8, gf32, 256),
                    key(16, gi8, other_f32, 256),
                    key(16, gi8[:256], gf32[:256], 256)):
        assert changed != base
    assert base[0] == torch.device("cpu") and base[1:5] == (16, 32, 512,
                                                             256)


def _entry(graphs, device, key):
    """The entry under ``key``, made (as the key itself) when missing."""
    got = graphs._get(device, key)
    if got is None:
        got = key
        graphs._put(device, key, got)
    return got


def test_entries_leave_least_recently_used_first():
    """A card keeps one entry per bucket; past that the least recently
    used goes, and another card's entries are its own."""
    graphs = search.Int8ScanGraphs()
    cap = len(search.GRAPH_QUERIES)
    cpu, other = torch.device("cpu"), torch.device("meta")
    for key in range(cap):
        _entry(graphs, cpu, key)
    _entry(graphs, cpu, 0)      # 0 is now the most recently used
    _entry(graphs, other, "x")
    _entry(graphs, cpu, cap)    # evicts 1
    assert list(graphs._entries[cpu]) == [*range(2, cap), 0, cap]
    assert graphs._get(cpu, 1) is None and graphs._get(other, "x") == "x"
    assert len(graphs) == cap + 1
    graphs.clear()
    assert len(graphs) == 0


def test_replays_count_the_runs_they_recorded():
    """A replay adds the launches its graph recorded to the kernel's runs;
    ``reset_counts`` zeroes runs and records alike."""
    lib = cuda_lib.CudaLibrary("k", {"f": [], "g": []})
    lib.recorded["f"] = 1
    lib.replayed({"f": 1, "g": 0})
    lib.replayed({"f": 1, "g": 2})
    assert lib.launches == 4 and lib.counts == {"f": 2, "g": 2}
    lib.reset_counts()
    assert lib.launches == 0 and lib.recorded == {"f": 0, "g": 0}


def test_a_query_row_is_scored_alone():
    """What a bucket's padding rests on, on the CPU: the rows of a query
    batch come out of the eager chain as they do in a batch with other
    rows after them."""
    gi8, gf32 = _mirrors(4096, 64, 34, torch.device("cpu"))
    mask = _mask(4096, 0.6, 35, torch.device("cpu"))
    three = _queries(gf32, 3, 36)
    padded = np.concatenate([three, _queries(gf32, 5, 37)])
    _assert_same([t[:3] for t in _eager(padded, gi8, gf32, mask)],
                 _eager(three, gi8, gf32, mask))


@pytest.mark.parametrize("write,dropped", [("overwrite", False),
                                           ("grow", True),
                                           ("compact", True)])
def test_gallery_drops_graphs_where_its_mirrors_are_rebuilt(write, dropped):
    """An in-place overwrite keeps the entries (the mirrors keep their
    pointers); a growth past the padding and a compaction rebuild the
    mirrors and drop them."""
    n, d = 256, 16
    rows = _rows(n + 1, d, 24)
    g = store.Gallery("drop", dim=d, device="cpu")
    g.upsert([f"p{i}" for i in range(n)], rows[:n], _payloads(n))
    g.search(rows[:2], k=3, method="int8")
    g._int8_graphs._put(torch.device("cpu"), "held", "entry")
    if write == "overwrite":
        g.upsert(["p3"], rows[n:], _payloads(1))
    elif write == "grow":
        g.upsert(["new"], rows[n:], _payloads(1))
    else:
        g.delete(["p3"])
        g.compact()
    g.search(rows[:2], k=3, method="int8")
    assert (len(g._int8_graphs) == 0) == dropped


def test_sharded_view_drops_graphs_when_its_int8_mirror_builds():
    rows = _rows(1000, 16, 25)
    view = sharded.ShardedGallerySearcher(
        rows, np.ones(1000, bool), make_mesh({"gallery": 2}, ["cpu"] * 2))
    view._int8_graphs._put(torch.device("cpu"), "held", "entry")
    view.ensure_mirror("int8")
    assert len(view._int8_graphs) == 0


def test_entries_hold_under_many_threads():
    """Sixteen threads take entries of ten keys on two cards, with clears
    among them and a short switch interval: every call gets its key's
    entry and no card outgrows its bound."""
    graphs = search.Int8ScanGraphs()
    cards = (torch.device("cpu"), torch.device("meta"))
    wrong: list[tuple] = []
    sizes: list[int] = []

    def worker(w):
        for j in range(400):
            key, card = (w * 7 + j) % 10, cards[(w + j) % 2]
            if _entry(graphs, card, key) != key:
                wrong.append((w, j))
            if j % 97 == 0:
                graphs.clear()
            with graphs._lock:
                sizes.append(max(map(len, graphs._entries.values()),
                                 default=0))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not wrong and len(sizes) == 16 * 400
    assert max(sizes) <= len(search.GRAPH_QUERIES)
