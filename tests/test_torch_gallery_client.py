"""Wire compatibility both ways: the port's client against the port's
server and the JAX server, and the JAX client against the port's server.

Each client drives one remote collection through the ``Gallery`` surface
the stages use (create, binary upsert, count, search with filters and
vectors, scroll, retrieve, by-path, distinct, delete, maintain, warm,
rename, snapshot). The port's client gets the same answers from either
server (scores within 1e-6), binary upserts are bit-exact, and the
client's retry rules hold: a JSON-only server gets the array resent as
JSON, a validation 400 is not resent. Oracle: tests/test_gallery_client.py.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from unittest import mock

import numpy as np
import pytest

from retrieval_based_object_detection_tpu.gallery import client as JC
from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery import server as JS
from retrieval_based_object_detection_tpu_torch.gallery import client as TC
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery import server as TS
from retrieval_based_object_detection_tpu_torch.gallery.store import VectorStore
from tests.torch_service_util import running

DIM = 16


def _serve(kind, root):
    if kind == "jax":
        return JS.serve(root, host="127.0.0.1", port=0)
    return TS.serve(root, host="127.0.0.1", port=0, device="cpu")


def _session(C, schema, base):
    """One client session; returns what it read, as plain values."""
    rng = np.random.default_rng(1)
    store = C.RemoteVectorStore(base)
    g = store.create_collection("demo", dim=DIM)
    vecs = rng.normal(size=(30, DIM)).astype(np.float32)
    pls = [schema.Payload(data_type="original_images",
                          class_name="a" if i < 12 else "b",
                          img_path=f"/i/{i}.jpg", is_segmented=i % 3 == 0)
           for i in range(30)]
    out = {"upserted": g.upsert([f"p{i}" for i in range(30)], vecs, pls)}
    out["list"] = store.list_collections()
    out["len"], out["dim"] = len(g), g.dim
    fa = schema.Filter(must={"class_name": "a"})
    out["count_a"] = g.count(fa)
    out["count_not"] = g.count(schema.Filter(must_not=[("class_name", "a")]))
    q = vecs[[3, 20]] + 0.02
    out["search"] = [[(h.id, h.score) for h in r] for r in g.search(q, k=4)]
    out["search_f"] = [[(h.id, h.score, h.payload.to_dict()) for h in r]
                       for r in g.search(q, k=3, flt=fa, exact=False)]
    out["search_v"] = [[h.vector.tolist() for h in r]
                       for r in g.search(q[:1], k=2, with_vectors=True,
                                         method="int8")]
    page, nxt = g.scroll(limit=7, offset=5)
    out["scroll"] = ([r.id for r in page], nxt)
    out["scroll_all"] = [r.vector.tolist()
                         for r in g.scroll_all(with_vectors=True)]
    out["retrieve"] = [(r.id, r.payload.to_dict(), r.vector.tolist())
                       for r in g.retrieve(["p4", "zz", "p29"])]
    rec = g.get_by_path("/i/./7.jpg")
    out["by_path"] = (rec.id, rec.vector.tolist())
    out["by_path_miss"] = g.get_by_path("/nope.jpg")
    out["distinct"] = g.distinct("class_name")
    out["matching"] = g.vectors_matching(fa).shape
    out["deleted"] = g.delete(ids=["p0", "p1", "zz"])
    out["deleted_f"] = g.delete(flt=schema.Filter(
        must={"class_name": "b", "is_segmented": True}))
    out["maintain"] = g.maintain(force=True)
    out["warm"] = g.warm() >= 0
    out["after"] = [[(h.id, h.score) for h in r] for r in g.search(q, k=4)]
    store.rename_collection("demo", "demo2")
    out["renamed"] = ("demo" in store, "demo2" in store)
    with pytest.raises(C.GalleryServiceError) as e:
        C.GalleryClient(base, "demo").count()
    out["missing_status"] = e.value.status
    out["snapshot"] = store.snapshot()
    out["bit_exact"] = bool((np.stack([np.asarray(v, np.float32)
                                       for v in out["scroll_all"]])
                             == vecs[:30]).all())
    return out


def _same(a, b):
    if isinstance(a, float):
        assert abs(a - b) <= 1e-6, (a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_clients_agree_across_servers(client, tmp_path):
    """Each client gets the same answers from the JAX and the port
    server."""
    C, schema = (TC, tschema) if client == "port" else (JC, jschema)
    got = {}
    for kind in ("jax", "port"):
        with running(_serve(kind, tmp_path / kind)) as base:
            got[kind] = _session(C, schema, base)
    assert got["port"]["bit_exact"] and got["port"]["upserted"] == 30
    assert got["port"]["missing_status"] == 404
    _same(got["jax"], got["port"])


def test_json_fallback_against_a_json_only_server():
    """Against a server without the binary frame (it answers the frame
    with ``bad json``), the port client resends the array as JSON."""
    store = VectorStore(device="cpu")
    g = store.create_collection("old", dim=8)

    class OldHandler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _out(self, obj, code=200):
            b = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(b)))
            self.end_headers()
            self.wfile.write(b)

        def do_POST(self):
            raw = self.rfile.read(int(self.headers["Content-Length"]))
            try:
                body = json.loads(raw.decode("utf-8", "replace"))
            except json.JSONDecodeError:
                return self._out({"error": "bad json"}, 400)
            if self.path.endswith("/points"):
                return self._out({"upserted": g.upsert(
                    body["ids"], np.asarray(body["vectors"], np.float32),
                    body["payloads"])})
            res = g.search(np.asarray(body["queries"], np.float32),
                           k=body["k"])
            return self._out({"results": [
                [{"id": r.id, "score": r.score,
                  "payload": r.payload.to_dict()} for r in hits]
                for hits in res]})

    with running(ThreadingHTTPServer(("127.0.0.1", 0), OldHandler)) as base:
        c = TC.GalleryClient(base, "old", dim=8)
        vecs = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
        pls = [tschema.Payload(data_type="original_images", class_name="x",
                               img_path=f"/o/{i}.jpg") for i in range(4)]
        assert c.upsert([f"o{i}" for i in range(4)], vecs, pls) == 4
        assert c.search(vecs[1], k=2)[0][0].id == "o1"


def test_validation_400_is_not_resent(tmp_path):
    with running(_serve("port", tmp_path / "s")) as base:
        g = TC.RemoteVectorStore(base).create_collection("v", dim=8)
        calls = {"n": 0}
        real = TC.urllib.request.urlopen

        def counting(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        pls = [tschema.Payload(data_type="original_images", class_name="x")
               for _ in range(2)]
        with mock.patch.object(TC.urllib.request, "urlopen", counting):
            with pytest.raises(TC.GalleryServiceError) as e:
                g.upsert(["a", "b", "c"], np.ones((3, 8), np.float32), pls)
        assert e.value.status == 400 and calls["n"] == 1


def test_binary_upsert_reaches_the_store_as_a_copy(tmp_path):
    """The binary frame's vectors arrive as a read-only view of the request
    bytes; the store keeps its own copy on the host and on the device."""
    srv = _serve("port", tmp_path / "s")
    with running(srv) as base:
        g = TC.RemoteVectorStore(base).create_collection("c", dim=8)
        vecs = np.arange(24, dtype=np.float32).reshape(3, 8) + 1
        g.upsert(["a", "b", "c"], vecs,
                 [tschema.Payload(data_type="o", class_name="x")] * 3)
        hits = g.search(vecs, k=1, with_vectors=True)
        assert [h[0].id for h in hits] == ["a", "b", "c"]
        local = srv.service.store.get("c")
        assert local._vectors.flags.writeable
        assert (local._vectors[:3] == vecs).all()


def test_neg_filters_refused_by_an_old_server(tmp_path):
    """A must_not/should filter is refused, not silently dropped, by a
    server whose /healthz does not advertise them."""
    with running(_serve("port", tmp_path / "s")) as base:
        c = TC.RemoteVectorStore(base).create_collection("n", dim=8)
        c._neg_filters_ok = False
        with pytest.raises(TC.GalleryServiceError, match="must_not"):
            c.count(tschema.Filter(must_not=[("class_name", "x")]))
        c._neg_filters_ok = None
        assert c.count(tschema.Filter(must_not=[("class_name", "x")])) == 0
        assert c._neg_filters_ok is True
