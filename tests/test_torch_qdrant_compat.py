"""Port parity: the Qdrant wire-compatible façade against the JAX one.

The raw REST calls the reference's qdrant-client issues (recreate, per-point
upsert, filtered scroll, count, retrieve, search with must / must_not /
should and ``params.exact``, delete) and the façade's 400/404/409 errors go
to a JAX façade and a port façade (``device="cpu"``) over copies of one
root: equal status codes and JSON envelopes, scores within 1e-6. The port
façade's hits equal its native API's. Oracle: tests/test_qdrant_compat.py.
"""

import numpy as np
import pytest

from retrieval_based_object_detection_tpu.gallery import server as JS
from retrieval_based_object_detection_tpu_torch.gallery import server as TS
from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
    gallery_mesh,
)
from tests.torch_service_util import (
    assert_same,
    build_root,
    call,
    copy_root,
    replay,
    running,
)

DIM = 16


@pytest.fixture
def facades(tmp_path):
    build_root(tmp_path / "seed", dim=DIM)
    copy_root(tmp_path / "seed", tmp_path / "jax")
    copy_root(tmp_path / "seed", tmp_path / "port")
    js = JS.serve(tmp_path / "jax", host="127.0.0.1", port=0, api="qdrant")
    ts = TS.serve(tmp_path / "port", host="127.0.0.1", port=0, api="qdrant",
                  device="cpu")
    with running(js) as jb, running(ts) as tb:
        yield jb, tb, ts


def _cond(key, value):
    return {"key": key, "match": {"value": value}}


def _steps():
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(6, DIM)).astype(np.float32)
    c = "/collections"
    steps = [("GET", "/healthz", None),
             ("DELETE", f"{c}/demo", None),
             ("PUT", f"{c}/demo",
              {"vectors": {"size": DIM, "distance": "Cosine"}}),
             ("PUT", f"{c}/demo",
              {"vectors": {"size": DIM, "distance": "Cosine"}}),   # 409
             ("PUT", f"{c}/bad", {"vectors": {"size": DIM,
                                              "distance": "Hamming"}}),
             ("PUT", f"{c}/bad", {}),                               # 400
             ("GET", c, None),
             ("GET", f"{c}/demo", None),
             ("GET", f"{c}/nope", None)]                            # 404
    for i in range(6):
        steps.append(("PUT", f"{c}/demo/points?wait=true", {"points": [{
            "id": f"{i:032x}", "vector": vecs[i].tolist(),
            "payload": {"data_type": "original_images", "is_cropped": True,
                        "is_segmented": i % 2 == 0, "is_augmented": False,
                        "class_name": "cola" if i < 4 else "fanta",
                        "is_delegate": False, "delegate_type": None,
                        "img_path": f"/d/{i}.png"}}]}))
    cola = {"filter": {"must": [_cond("class_name", "cola"),
                                _cond("is_delegate", False)]}}
    steps += [
        ("PUT", f"{c}/demo/points", {"points": [{"vector": [0.0] * DIM}]}),
        ("PUT", f"{c}/demo/points",
         {"points": [{"id": "x", "vector": [[1], [2]]}]}),
        ("PUT", f"{c}/demo/points", {"points": [{
            "id": "x", "vector": [0.0] * DIM, "payload": {"colour": 1}}]}),
        ("PUT", f"{c}/demo/points", {}),
        ("GET", f"{c}/demo", None),
        ("POST", f"{c}/demo/points/scroll",
         {"limit": 100, "with_payload": True, "with_vector": True, **cola}),
        ("POST", f"{c}/demo/points/scroll", {"limit": 2, "offset": 1}),
        ("POST", f"{c}/demo/points/scroll",
         {"limit": 10, "with_payload": False,
          "filter": {"must_not": [_cond("class_name", "cola")]}}),
        ("POST", f"{c}/demo/points/scroll",
         {"filter": {"nested": {"key": "x"}}}),                    # 400
        ("POST", f"{c}/demo/points/scroll",
         {"filter": {"must": [{"key": "x", "range": {"gt": 1}}]}}),  # 400
        ("POST", f"{c}/demo/points/scroll",
         {"filter": {"must": [_cond("colour", "red")]}}),          # 400
        ("POST", f"{c}/demo/points/scroll",
         {"filter": {"must": [_cond("class_name", "cola"),
                              _cond("class_name", "fanta")]}}),    # 400
        ("POST", f"{c}/demo/points/count", {"exact": True}),
        ("POST", f"{c}/demo/points/count",
         {"filter": {"should": [_cond("class_name", "fanta"),
                                _cond("is_segmented", True)]}}),
        ("POST", f"{c}/demo/points",
         {"ids": [f"{2:032x}", "missing"], "with_payload": True,
          "with_vector": True}),
        ("POST", f"{c}/demo/points", {}),                           # 400
        ("POST", f"{c}/demo/points/search",
         {"vector": vecs[1].tolist(), "limit": 3, "with_payload": True}),
        ("POST", f"{c}/demo/points/search",
         {"vector": vecs[1].tolist(), "limit": 3, "with_vector": True,
          "params": {"exact": True}, **cola}),
        ("POST", f"{c}/demo/points/search",
         {"vector": vecs[4].tolist(), "limit": 4,
          "filter": {"must_not": [_cond("is_segmented", True)],
                     "should": [_cond("class_name", "cola"),
                                _cond("class_name", "fanta")]}}),
        ("POST", f"{c}/demo/points/search", {"limit": 3}),          # 400
        ("POST", f"{c}/nope/points/search",
         {"vector": vecs[0].tolist()}),                             # 404
        ("POST", f"{c}/prod/points/search",
         {"vector": [0.5] * DIM, "limit": 5, "params": {"exact": True}}),
        ("POST", f"{c}/demo/points/delete", {"points": [f"{0:032x}"]}),
        ("POST", f"{c}/demo/points/delete",
         {"filter": {"must": [_cond("class_name", "fanta")]}}),
        ("POST", f"{c}/demo/points/delete", {}),                    # 400
        ("POST", f"{c}/demo/points/count", {}),
        ("GET", f"{c}/demo/unknown", None),                         # 404
        ("GET", "/nowhere", None),                                  # 404
        ("POST", f"{c}/demo/points/scroll", ("raw", b"{oops")),     # 400
        ("DELETE", f"{c}/demo", None),
        ("GET", c, None),
    ]
    return steps, vecs


def test_reference_call_sites_match_jax(facades):
    jb, tb, _ = facades
    steps, _ = _steps()
    out = replay(steps, [jb, tb])
    assert sorted({s for s, _ in out}) == [200, 400, 404, 409]
    status, text, headers = call("GET", f"{tb}/healthz")
    assert text == "healthz check passed" and \
        headers["X-Rbod-Warming"] == "false"


def test_facade_search_equals_native_search(tmp_path):
    """The façade (approximate by default, exact with ``params.exact``)
    returns the same hits as the port's native API over the same root."""
    vecs = build_root(tmp_path / "root", dim=DIM, n=50)
    qd = TS.serve(tmp_path / "root", host="127.0.0.1", port=0, api="qdrant",
                  device="cpu")
    nat = TS.serve(tmp_path / "root", host="127.0.0.1", port=0,
                   device="cpu")
    q = (vecs[7] + 0.1).tolist()
    must = {"must": [{"key": "class_name", "match": {"value": "fanta"}}]}
    with running(qd) as qb, running(nat) as nb:
        for exact in (False, True):
            _, hits, _ = call("POST", f"{qb}/collections/prod/points/search",
                              {"vector": q, "limit": 5, "filter": must,
                               "params": {"exact": exact}})
            _, native, _ = call(
                "POST", f"{nb}/collections/prod/points/search",
                {"queries": [q], "k": 5, "exact": exact,
                 "filter": {"class_name": "fanta"}})
            assert_same([(h["id"], h["score"], h["payload"])
                         for h in hits["result"]],
                        [(h["id"], h["score"], h["payload"])
                         for h in native["results"][0]])
            assert len(hits["result"]) == 5


def test_facade_over_a_sharded_store(facades):
    """With a 4-shard CPU mesh attached, the façade serves through the
    sharded tier and its hits equal the JAX façade's."""
    jb, tb, ts = facades
    ts.service.store.attach_mesh(gallery_mesh(4, device="cpu"))
    rng = np.random.default_rng(9)
    q = rng.normal(size=DIM).tolist()
    replay([("POST", "/collections/prod/points/search",
             {"vector": q, "limit": 6, "params": {"exact": True}}),
            ("POST", "/collections/prod/points/search",
             {"vector": q, "limit": 6, "params": {"exact": True},
              "filter": {"must": [{"key": "class_name",
                                   "match": {"value": "cola"}}]}})],
           [jb, tb])
    assert ts.service.store.get("prod")._shard_view is not None
