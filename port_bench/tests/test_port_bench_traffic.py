"""Every traffic generator repeats exactly for a seed, and another seed
gives the same amount of work in another order."""

from __future__ import annotations

import numpy as np
import torch

from benchcore import spec
from benchcore.weights import clip_state

BIG_SEED = 2 ** 31 + 12345


def params(cell):
    return spec.workload(cell)["params"]


def test_detect_schedule_and_uploads_repeat():
    kind = spec.traffic("detect_http")
    p = {**params("vitb32-detect-steady"),
         "photo_sizes": [[96, 128], [128, 96]], "photos_per_size": 3}
    a = kind.upload_pool(BIG_SEED, p, 100)
    assert a == kind.upload_pool(BIG_SEED, p, 100)
    assert a != kind.upload_pool(BIG_SEED + 1, p, 100)
    s1 = kind.schedule(BIG_SEED, 40.0, 10.0, len(a))
    assert s1 == kind.schedule(BIG_SEED, 40.0, 10.0, len(a))
    s2 = kind.schedule(7, 40.0, 10.0, len(a))
    assert len(s1) == len(s2) == 400
    # Every seed sends every pool entry equally often.
    assert sorted(b for _, b in s1) == sorted(b for _, b in s2)
    assert all(0 <= t < 10.0 for t, _ in s1)
    assert [t for t, _ in s1] == sorted(t for t, _ in s1)
    # ... and the same gaps between arrivals, in another order.
    g1, g2 = (np.diff([t for t, _ in s] + [10.0]) for s in (s1, s2))
    assert not np.array_equal(g1, g2)
    assert np.allclose(np.sort(g1), np.sort(g2))


def test_gallery_crops_repeat():
    kind = spec.traffic("detect_http")
    a, la = kind.gallery_crops(BIG_SEED, 3, 2, 32)
    b, lb = kind.gallery_crops(BIG_SEED, 3, 2, 32)
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert list(la) == [0, 0, 1, 1, 2, 2]


def test_search_rows_and_calls_repeat():
    kind = spec.traffic("search_inproc")
    p = {**params("vitb32-search-1m"), "rows": 4096, "dim": 32,
         "calls_per_caller": 6}
    dev = torch.device("cpu")
    r1, c1, d1 = kind.make_rows(torch, BIG_SEED, p, dev)
    r2, c2, d2 = kind.make_rows(torch, BIG_SEED, p, dev)
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    assert torch.equal(d1, d2)
    calls1 = kind.make_calls(torch, BIG_SEED, p, r1, c1.numpy(), d1.numpy())
    calls2 = kind.make_calls(torch, BIG_SEED, p, r2, c2.numpy(), d2.numpy())
    assert len(calls1) == p["callers"]
    for x, y in zip(calls1, calls2):
        assert len(x) == p["calls_per_caller"]
        for (qa, fa, va), (qb, fb, vb) in zip(x, y):
            assert np.array_equal(qa, qb) and (fa, va) == (fb, vb)
            assert qa.shape == (p["queries_per_call"], p["dim"])
    fields = [f for per in calls1 for _, f, _ in per]
    assert fields.count("class_name") == fields.count("data_type")


def test_embed_tree_repeats(tmp_path):
    kind = spec.traffic("embed_tree")
    p = {**params("vitb32-embed-tree"), "crops": 12, "classes": 4,
         "min_side": 40, "max_side": 60}
    a = kind.write_tree(BIG_SEED, p, tmp_path / "a" / "dataset_cropped")
    b = kind.write_tree(BIG_SEED, p, tmp_path / "b" / "dataset_cropped")
    assert [n for _, n in a] == [n for _, n in b]
    assert all(x.read_bytes() == y.read_bytes()
               for (x, _), (y, _) in zip(a, b))
    assert len({n for _, n in a}) == 4


def test_weights_repeat_and_differ_by_seed():
    cfg = {**spec.config("clip-vit-b32"), "width": 32, "layers": 2,
           "heads": 2, "embed_dim": 16, "image_size": 64}
    a = clip_state(torch, cfg, BIG_SEED, "cpu")
    b = clip_state(torch, cfg, BIG_SEED, "cpu")
    c = clip_state(torch, cfg, BIG_SEED + 1, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj"], c["proj"])
    assert a["blocks.1.w_fc"].shape == (32, 128)
