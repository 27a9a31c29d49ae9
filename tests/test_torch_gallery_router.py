"""Port parity: the shard router against the JAX package's.

Two JAX shard servers behind a JAX router, and two port shard servers
(``device="cpu"``) behind a port router, take one scripted request
sequence through the routers' native API and their Qdrant façades: equal
status codes and JSON bodies, scores within 1e-6. ``shard_of`` (MD5) is
equal bit for bit on 10,000 ids, the router's exact top-k equals one
server's over the same rows, and a dead shard fails loudly. Oracle:
tests/test_gallery_router.py.
"""

import contextlib

import numpy as np
import pytest

from retrieval_based_object_detection_tpu.gallery import router as JR
from retrieval_based_object_detection_tpu.gallery import server as JS
from retrieval_based_object_detection_tpu_torch.gallery import router as TR
from retrieval_based_object_detection_tpu_torch.gallery import server as TS
from retrieval_based_object_detection_tpu_torch.gallery.client import (
    GalleryClient,
    RemoteVectorStore,
)
from retrieval_based_object_detection_tpu_torch.gallery.schema import Filter
from tests.torch_service_util import call, payload, replay, running

DIM = 16


def _topology(stack, tmp_path, tag, serve, serve_router, api="native",
              **kw):
    urls = [stack.enter_context(running(serve(
        tmp_path / f"{tag}{i}", host="127.0.0.1", port=0, **kw)))
        for i in range(2)]
    router = serve_router(urls, host="127.0.0.1", port=0, api=api)
    return stack.enter_context(running(router)), urls


@pytest.fixture
def routers(tmp_path):
    with contextlib.ExitStack() as stack:
        jb, _ = _topology(stack, tmp_path, "j", JS.serve, JR.serve_router)
        tb, turls = _topology(stack, tmp_path, "t", TS.serve,
                              TR.serve_router, device="cpu")
        yield jb, tb, turls, tmp_path


def test_shard_of_is_bit_exact():
    ids = [f"id{i}" for i in range(5000)] + [
        f"{i:032x}" for i in range(0, 5000 * 7919, 7919)]
    for n in (2, 3, 8):
        want = [JR.shard_of(p, n) for p in ids]
        assert [TR.shard_of(p, n) for p in ids] == want
    assert len(set(want)) == 8


def _steps():
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(120, DIM)).astype(np.float32)
    q = vecs[[3, 50, 99]] + 0.02
    c = "/collections/prod"
    pls = [payload(i) for i in range(120)]
    return [
        ("PUT", c, {"dim": DIM}),
        ("PUT", c, {"dim": DIM}),                                   # 409
        ("POST", f"{c}/points",
         ("binary", {"ids": [f"p{i}" for i in range(100)],
                     "payloads": pls[:100]}, vecs[:100], "vectors")),
        ("POST", f"{c}/points",
         {"ids": [f"p{i}" for i in range(100, 120)],
          "vectors": vecs[100:].tolist(), "payloads": pls[100:]}),
        ("POST", f"{c}/points", {"ids": ["p0"]}),                   # 400
        ("GET", "/collections", None),
        ("POST", f"{c}/count", {}),
        ("POST", f"{c}/count", {"filter": {"class_name": "cola"}}),
        ("POST", f"{c}/points/search",
         ("binary", {"k": 7, "method": "exact"}, q, "queries")),
        ("POST", f"{c}/points/search",
         {"queries": q.tolist(), "k": 5, "method": "int8"}),
        ("POST", f"{c}/points/search",
         {"queries": q.tolist(), "k": 5, "exact": False,
          "filter_not": [["class_name", "fanta"]]}),
        ("POST", f"{c}/points/search",
         {"queries": q.tolist(), "k": 4, "with_vectors": True,
          "filter_should": [["class_name", "cola"],
                            ["is_segmented", True]]}),
        ("POST", f"{c}/points/search", {"k": 3}),                   # 400
        ("POST", f"{c}/points/scroll", {"limit": 30}),
        ("POST", f"{c}/points/scroll", {"limit": 30, "offset": 45}),
        ("POST", f"{c}/points/scroll",
         {"limit": 7, "offset": 3, "filter": {"class_name": "sprite"}}),
        ("POST", f"{c}/points/scroll", {"limit": 0}),               # 400
        ("POST", f"{c}/points/retrieve",
         {"ids": ["p7", "zz", "p64", "p7"], "with_vectors": True}),
        ("POST", f"{c}/points/by-path", {"img_path": "/data/prod/12.png"}),
        ("POST", f"{c}/points/by-path", {"img_path": "/none.png"}),
        ("POST", f"{c}/points/delete", {"ids": ["p3", "p50", "nope"]}),
        ("POST", f"{c}/points/delete", {"filter": {"class_name": "fanta",
                                                   "is_segmented": True}}),
        ("POST", f"{c}/points/search",
         {"queries": q.tolist(), "k": 5, "method": "exact"}),
        ("POST", f"{c}/maintain", {"force": True}),
        ("POST", f"{c}/count", {}),
        ("POST", "/snapshot", None),
        ("POST", f"{c}/rename", {"new_name": "prod2"}),
        ("POST", "/collections/prod2/points/search",
         {"queries": q.tolist(), "k": 5}),
        ("GET", "/collections/prod/count", None),                   # 404
        ("DELETE", "/collections/prod2", None),
        ("GET", "/collections", None),
    ]


def test_scripted_sequence_matches_jax(routers):
    jb, tb, turls, _ = routers
    out = replay(_steps(), [jb, tb])
    assert sorted({s for s, _ in out}) == [200, 400, 404, 409]
    # The collection delete reached every port shard.
    assert all(call("GET", f"{u}/collections")[1] == [] for u in turls)


def test_router_exact_equals_one_server(routers, tmp_path):
    """The port router's exact top-k over two shards equals one port
    server's exact top-k over all the rows, ids and scores."""
    _, tb, turls, _ = routers
    one = TS.serve(tmp_path / "one", host="127.0.0.1", port=0, device="cpu")
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(300, DIM)).astype(np.float32)
    ids = [f"r{i}" for i in range(300)]
    pls = [payload(i) for i in range(300)]
    q = vecs[[1, 100, 299]] + 0.05 * rng.normal(size=(3, DIM))
    with running(one) as ob:
        got_all = []
        for base in (tb, ob):
            g = RemoteVectorStore(base).create_collection("x", dim=DIM)
            g.upsert(ids, vecs, pls)
            got_all.append([g.search(q, k=10, flt=f) for f in
                            (None, Filter(must={"class_name": "cola"}))])
        for via_router, single in zip(*got_all):
            for a, b in zip(via_router, single):
                assert [h.id for h in a] == [h.id for h in b]
                np.testing.assert_allclose([h.score for h in a],
                                           [h.score for h in b], atol=1e-6)
    counts = [GalleryClient(u, "x").count() for u in turls]
    assert sum(counts) == 300 and min(counts) > 100


def test_qdrant_facade_over_routers_matches_jax(tmp_path):
    with contextlib.ExitStack() as stack:
        jb, _ = _topology(stack, tmp_path, "j", JS.serve, JR.serve_router,
                          api="qdrant")
        tb, _ = _topology(stack, tmp_path, "t", TS.serve, TR.serve_router,
                          api="qdrant", device="cpu")
        rng = np.random.default_rng(6)
        vecs = rng.normal(size=(12, DIM)).astype(np.float32)
        c = "/collections/demo"
        steps = [("PUT", c, {"vectors": {"size": DIM,
                                         "distance": "Cosine"}}),
                 ("PUT", f"{c}/points", {"points": [
                     {"id": f"{i:032x}", "vector": vecs[i].tolist(),
                      "payload": payload(i)} for i in range(12)]}),
                 ("GET", c, None),
                 ("POST", f"{c}/points/count", {}),
                 ("POST", f"{c}/points/scroll",
                  {"limit": 5, "with_vector": True}),
                 ("POST", f"{c}/points/search",
                  {"vector": vecs[5].tolist(), "limit": 4,
                   "params": {"exact": True},
                   "filter": {"must_not": [{"key": "class_name",
                                            "match": {"value": "cola"}}]}}),
                 ("POST", f"{c}/points/delete",
                  {"points": [f"{5:032x}"]}),
                 ("POST", f"{c}/points/count", {}),
                 ("DELETE", c, None)]
        out = replay(steps, [jb, tb])
        assert all(s == 200 for s, _ in out)


def test_dead_shard_is_loud(tmp_path):
    """A shard that does not answer makes the router return a 500, never a
    partial result."""
    with contextlib.ExitStack() as stack:
        live = stack.enter_context(running(TS.serve(
            tmp_path / "a", host="127.0.0.1", port=0, device="cpu")))
        dead = TS.serve(tmp_path / "b", host="127.0.0.1", port=0,
                        device="cpu")
        dead_url = f"http://127.0.0.1:{dead.server_address[1]}"
        dead.server_close()  # bound once, now refusing connections
        base = stack.enter_context(running(TR.serve_router(
            [live, dead_url], host="127.0.0.1", port=0)))
        status, body, _ = call("GET", f"{base}/collections")
        assert status == 500 and "unreachable" in body["error"]
        assert call("GET", f"{base}/healthz")[0] == 500
