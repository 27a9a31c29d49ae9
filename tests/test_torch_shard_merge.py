"""The sharded int8 tier's merge, P2 (``ops/shard_merge.py``).

On the CPU: the plain version against the merge the other tiers take
(``sharded._gather_merge``) over each shard's best k by ``lax.top_k``'s
rule, with ties inside and across shards, ``NEG_INF`` candidates, fewer
live candidates than k, a query count below its graph bucket, 1 to 8
shards and k of 1, 10 and r; ``emulate_merge``, the kernel of
``csrc/shard_merge.cu`` step by step in numpy (order keys, the four
digits, the block scan's slots, the ranks above T), against the plain
version on the same cases; and the wrapper's checks.

On the card (``cuda`` marker; skipped without one): the kernel equals the
plain version bit for bit at the sharded cell's [16, 4 × 256] with k = 10
and at k = r, on the CPU cases, past the candidates its shared memory
holds, and with two or more cards over peer access and over copies, in
order with the cards' streams on both sides of the merge. No JAX here, so
the card tests run on a machine with only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_shard_merge.py
"""

import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu_torch.gallery import search
from retrieval_based_object_detection_tpu_torch.gallery import sharded
from retrieval_based_object_detection_tpu_torch.ops import shard_merge as SM

NEG_INF = np.float32(search.NEG_INF)
R = 48  # candidates a shard in the CPU cases (not a power of two)


@pytest.fixture
def cuda_device():
    # Decided here, not at import, so every test worker collects the same
    # tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _case(kind: str, shards: int, rng, q: int = 5, r: int = R):
    """(scores [S, q, r] f32, local rows [S, q, r] int64, rows_per). The
    rows are distinct within a shard and its query, as the candidate
    select gives them; masked candidates come after the live ones."""
    rows_per = 10 * r
    rows = np.stack([np.stack([rng.choice(rows_per, r, replace=False)
                               for _ in range(q)]) for _ in range(shards)])
    if kind == "ties":  # a few values, shared inside and across shards
        s = rng.integers(-2, 3, (shards, q, r)) / 4
        s[rng.random(s.shape) < 0.05] = -0.0
    elif kind == "neg-inf":  # the tail of each list masked
        s = rng.uniform(-1, 1, (shards, q, r))
        live = rng.integers(0, r + 1, (shards, q))
        s[np.arange(r) >= live[..., None]] = NEG_INF
    elif kind == "few-live":  # three live candidates in all
        s = np.full((shards, q, r), NEG_INF)
        for i in range(q):
            for _ in range(3):
                s[rng.integers(shards), i, rng.integers(r)] = rng.uniform()
        s = -np.sort(-s, axis=2)
    else:  # "below-bucket": q rows of a list made for the bucket above
        s = rng.uniform(-1, 1, (shards, q, r))
    return s.astype(np.float32), rows.astype(np.int64), rows_per


def _lists(scores, rows, device="cpu", q=None):
    """Per-shard tensors; ``q``: the first q rows of the [S, q', r] lists,
    as views (a graph bucket's static outputs sliced to the call)."""
    s = [torch.from_numpy(x).to(device) for x in scores]
    i = [torch.from_numpy(x).to(device) for x in rows]
    if q is not None:
        s, i = [t[:q] for t in s], [t[:q] for t in i]
    return s, i


def _best_k(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """One shard's best k by ``lax.top_k``'s rule: the first k of a stable
    descending sort."""
    order = torch.sort(scores, dim=1, descending=True, stable=True
                       ).indices[:, :k]
    return torch.gather(scores, 1, order), torch.gather(rows, 1, order)


def _keys(v: np.ndarray) -> np.ndarray:
    """``key_of``: the scores' order keys, -0 as +0."""
    b = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    return np.where(b >> 31 == 1, ~b, b | np.uint32(0x80000000))


def _top_bin(hist: np.ndarray, want: int) -> tuple[int, int]:
    """``top_bin``: thread t holds the count of bins >= 255 - t."""
    x = np.cumsum(hist[::-1])
    short = int((x < want).sum())
    return 255 - short, (0 if short == 0 else int(x[short - 1]))


def emulate_merge(scores: np.ndarray, rows: np.ndarray, rows_per: int,
                  k: int) -> tuple[np.ndarray, np.ndarray]:
    """``shard_merge_kernel`` over [S, Q, r] lists, a query at a time: the
    four digits of T, each thread's contiguous run of m candidates, the
    block's exclusive scan of its counts above and at T, the staging
    slots, and the ranks of the slots above T. Every output slot is
    written once."""
    shards, nq, r = scores.shape
    n, threads = shards * r, 256
    m = -(-n // threads)
    out_s = np.full((nq, k), np.nan, np.float32)
    out_r = np.full((nq, k), -1, np.int64)
    for q in range(nq):
        vals = scores[:, q, :].reshape(-1)  # c = shard · r + position
        keys = _keys(vals).astype(np.int64)
        prefix, want, above = 0, k, 0
        for shift in (24, 16, 8, 0):
            high = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) \
                & 0xFFFFFFFF
            match = keys[(keys & high) == prefix]
            b, a = _top_bin(np.bincount((match >> shift) & 255,
                                        minlength=256), want)
            prefix |= b << shift
            above += a
            want -= a
        cut, need = prefix, want
        runs = [range(min(n, t * m), min(n, min(n, t * m) + m))
                for t in range(threads)]
        n_above = np.array([sum(keys[c] > cut for c in run) for run in runs])
        n_tied = np.array([sum(keys[c] == cut for c in run) for run in runs])
        staging = [None] * k
        for run, a, t in zip(runs, np.cumsum(n_above) - n_above,
                             np.cumsum(n_tied) - n_tied):
            for c in run:
                slot = None
                if keys[c] > cut:
                    slot, a = a, a + 1
                elif keys[c] == cut:
                    slot = above + t if t < need else None
                    t += 1
                if slot is not None:
                    assert staging[slot] is None
                    staging[slot] = (c, vals[c])
        for e, (c, v) in enumerate(staging):
            rank = e
            if e < above:
                rank = sum(keys[o] > keys[c] or (keys[o] == keys[c] and o < c)
                           for o, _ in staging[:above])
            assert np.isnan(out_s[q, rank])
            s, pos = divmod(c, r)
            out_s[q, rank] = v
            out_r[q, rank] = rows[s, q, pos] + s * rows_per
    return out_s, out_r


CASES = [(kind, shards, k) for kind in ("ties", "neg-inf", "few-live",
                                        "below-bucket")
         for shards in (1, 2, 4, 8) for k in (1, 10, R)]


# ------------------------------------------------- the rule, on the CPU


@pytest.mark.parametrize("kind,shards,k", CASES)
def test_plain_equals_the_eager_merge_of_each_shards_best_k(kind, shards, k):
    """The best k of the union equal ``_gather_merge`` of each shard's
    best k (both stable: shard order, then position), bit for bit."""
    rng = np.random.default_rng(shards * 100 + k)
    q = 3 if kind == "below-bucket" else None
    scores, rows, rows_per = _case(kind, shards, rng,
                                   q=4 if q else 5)
    s, i = _lists(scores, rows, q=q)
    got = SM.shard_merge_plain(s, i, rows_per, k)
    per = [_best_k(a, b, k) for a, b in zip(s, i)]
    want = sharded._gather_merge([p[0] for p in per], [p[1] for p in per],
                                 rows_per, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if kind == "few-live":
        assert (got[0][:, 3:] == NEG_INF).all()


@pytest.mark.parametrize("kind,shards,k", CASES)
def test_the_kernel_emulated_equals_the_plain_version(kind, shards, k):
    rng = np.random.default_rng(shards * 100 + k + 1)
    scores, rows, rows_per = _case(kind, shards, rng)
    got = emulate_merge(scores, rows, rows_per, k)
    want = SM.shard_merge_plain(*_lists(scores, rows), rows_per, k)
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[0], want[0].numpy())


def test_cpu_tensors_take_the_plain_version_without_launch():
    rng = np.random.default_rng(0)
    scores, rows, rows_per = _case("ties", 4, rng)
    s, i = _lists(scores, rows)
    before = SM.KERNEL.launches
    got = SM.shard_merge(s, i, rows_per, 10)
    assert SM.KERNEL.launches == before
    assert got.buf is None
    for a, b in zip((got.scores, got.rows),
                    SM.shard_merge_plain(s, i, rows_per, 10)):
        assert torch.equal(a, b)
    host = got.host()
    assert isinstance(host[0], np.ndarray) and host[1].dtype == np.int64


@pytest.mark.parametrize("shapes,k", [
    ([(2, 4), (2, 5)], 2), ([(2, 4), (2, 4)], 9), ([(2, 4)], -1),
    ([(4,)], 1)])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(shapes, k):
    s = [torch.zeros(shape) for shape in shapes]
    i = [torch.zeros(shape, dtype=torch.int64) for shape in shapes]
    with pytest.raises(ValueError):
        SM.shard_merge(s, i, 100, k)


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported devices"):
        SM.shard_merge([torch.zeros((2, 4), device="meta")],
                       [torch.zeros((2, 4), dtype=torch.int64,
                                    device="meta")], 100, 2)


# ------------------------------------------------------------ the card


def _on_card(scores, rows, rows_per, k, devices):
    """P2 over per-shard tensors placed on ``devices`` against the plain
    version on the CPU, bit for bit; one launch."""
    s = [torch.from_numpy(x).to(d) for x, d in zip(scores, devices)]
    i = [torch.from_numpy(x).to(d) for x, d in zip(rows, devices)]
    before = SM.KERNEL.launches
    got = SM.shard_merge(s, i, rows_per, k)
    assert SM.KERNEL.launches == before + 1
    assert got.scores.device == got.rows.device == s[0].device
    host = got.host()
    want = SM.shard_merge_plain(*_lists(scores, rows), rows_per, k)
    np.testing.assert_array_equal(host[1], want[1].numpy())
    np.testing.assert_array_equal(host[0], want[0].numpy())
    return host


def _serving_case(shards, r, seed):
    """Rescored candidates as the graphs give them: cosines of queries near
    their rows, a masked tail on some lists."""
    rng = np.random.default_rng(seed)
    scores, rows, rows_per = _case("neg-inf", shards, rng, q=16, r=r)
    live = scores > NEG_INF / 2
    scores[live] = np.clip(rng.normal(0.3, 0.2, live.sum()), -1, 1)
    return scores.astype(np.float32), rows, 294_912


@pytest.mark.cuda
@pytest.mark.parametrize("shards,r,k", [(4, 256, 10), (4, 256, 256),
                                        (4, 256, 1), (8, 640, 640),
                                        (2, 2048, 2048)],
                         ids=["the-cell", "k-is-r", "k-is-1",
                              "past-shared-memory", "two-large"])
def test_kernel_matches_plain_at_serving_shapes(cuda_device, shards, r, k):
    scores, rows, rows_per = _serving_case(shards, r, shards * r + k)
    _on_card(scores, rows, rows_per, k, [cuda_device] * shards)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shards,k", CASES)
def test_kernel_matches_plain_on_the_cpu_cases(cuda_device, kind, shards,
                                               k):
    rng = np.random.default_rng(shards * 100 + k + 1)
    scores, rows, rows_per = _case(kind, shards, rng)
    _on_card(scores, rows, rows_per, k, [cuda_device] * shards)


@pytest.mark.cuda
def test_a_bucket_prefix_is_read_in_place(cuda_device):
    """Three queries of lists made for four (a graph's static outputs
    sliced to the call): the merge of the three rows alone."""
    scores, rows, rows_per = _serving_case(4, 256, 7)
    s, i = _lists(scores[:, :4], rows[:, :4], cuda_device, q=3)
    got = SM.shard_merge(s, i, rows_per, 10).host()
    want = SM.shard_merge_plain(*_lists(scores[:, :3], rows[:, :3]),
                                rows_per, 10)
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[0], want[0].numpy())


def _cards(n_min=2):
    if torch.cuda.device_count() < n_min:
        pytest.skip(f"needs {n_min} or more cards")
    return [torch.device(f"cuda:{i}")
            for i in range(min(4, torch.cuda.device_count()))]


@pytest.mark.cuda
@pytest.mark.parametrize("peer", [True, False], ids=["peer", "copies"])
def test_shards_on_other_cards(cuda_device, monkeypatch, peer):
    """One shard a card: read over peer access where the cards allow it,
    and (the peer query's answer forced to no) from copies to the first."""
    cards = _cards()
    if not peer:
        monkeypatch.setattr(SM, "_peer", lambda first, other: False)
    elif not torch.cuda.can_device_access_peer(0, 1):
        pytest.skip("the cards cannot read each other's memory")
    scores, rows, rows_per = _serving_case(len(cards), 256, 11)
    for k in (10, 256):
        _on_card(scores, rows, rows_per, k, cards)


@pytest.mark.cuda
@pytest.mark.parametrize("peer", [True, False], ids=["peer", "copies"])
def test_the_merge_waits_for_the_cards_and_they_for_it(cuda_device,
                                                       monkeypatch, peer):
    """Each other card writes its candidates after a long wait on its
    stream, the first card's stream waits less, and each other card
    overwrites its candidates right after the merge is launched: the merge
    reads what was written before it, never what came after."""
    cards = _cards()
    if not peer:
        monkeypatch.setattr(SM, "_peer", lambda first, other: False)
    scores, rows, rows_per = _serving_case(len(cards), 256, 12)
    src = [(torch.from_numpy(a).to(d), torch.from_numpy(b).to(d))
           for a, b, d in zip(scores, rows, cards)]
    s = [torch.zeros_like(a) for a, _ in src]
    i = [torch.zeros_like(b) for _, b in src]
    for d in cards:
        torch.cuda.synchronize(d)
    cycles = 100_000_000  # ~60 ms at the H100's clock
    for d, (a, b), sd, id_ in zip(cards, src, s, i):
        with torch.cuda.device(d):
            torch.cuda._sleep(cycles if d != cards[0] else cycles // 2)
            sd.copy_(a)
            id_.copy_(b)
    got = SM.shard_merge(s, i, rows_per, 10)
    for d, sd in zip(cards[1:], s[1:]):
        with torch.cuda.device(d):
            sd.fill_(2.0)
    host = got.host()
    want = SM.shard_merge_plain(*_lists(scores, rows), rows_per, 10)
    np.testing.assert_array_equal(host[1], want[1].numpy())
    np.testing.assert_array_equal(host[0], want[0].numpy())
