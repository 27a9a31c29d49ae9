"""Port parity: the gallery HTTP service against the JAX package's.

A JAX server and a port server (``device="cpu"``) start on ephemeral ports
over copies of one snapshot root written by the JAX package. One scripted
request sequence, covering every endpoint of the native API and its
400/404/409 errors, goes to both: status codes and JSON bodies must be
equal, scores within 1e-6. After ``POST /snapshot`` the two roots hold the
same files, byte for byte, once the base snapshot's uuid is pinned.
Oracle: tests/test_gallery_server.py.
"""

import time
import uuid

import numpy as np
import pytest

from retrieval_based_object_detection_tpu.gallery import server as JS
from retrieval_based_object_detection_tpu_torch.gallery import server as TS
from tests.torch_service_util import (
    build_root,
    call,
    copy_root,
    payload,
    replay,
    running,
)

DIM = 8


@pytest.fixture
def fixed_uuid(monkeypatch):
    fixed = uuid.UUID(int=0x5EED)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)


@pytest.fixture
def pair(tmp_path, fixed_uuid):
    """(JAX base URL, port base URL, JAX root, port root, vectors)."""
    vecs = build_root(tmp_path / "seed")
    copy_root(tmp_path / "seed", tmp_path / "jax")
    copy_root(tmp_path / "seed", tmp_path / "port")
    js = JS.serve(tmp_path / "jax", host="127.0.0.1", port=0)
    ts = TS.serve(tmp_path / "port", host="127.0.0.1", port=0, device="cpu")
    with running(js) as jb, running(ts) as tb:
        yield jb, tb, tmp_path / "jax", tmp_path / "port", vecs


def _steps(vecs):
    rng = np.random.default_rng(5)
    q = (vecs[[3, 11]] + 0.05 * rng.normal(size=(2, DIM))).tolist()
    new = rng.normal(size=(6, DIM)).astype(np.float32)
    flt = {"filter": {"class_name": "cola"}}
    c = "/collections"
    return [
        ("GET", "/healthz", None),
        ("GET", c, None),
        ("PUT", f"{c}/new", {"dim": DIM}),
        ("PUT", f"{c}/new", {"dim": DIM}),                         # 409
        ("PUT", f"{c}/other", {"dim": DIM, "distance": "euclid"}),
        ("POST", f"{c}/new/points",
         {"ids": ["n0", "n1", "n2"], "vectors": new[:3].tolist(),
          "payloads": [payload(i, "new") for i in range(3)]}),
        ("POST", f"{c}/new/points",
         ("binary", {"ids": ["n3", "n4", "n2"],
                     "payloads": [payload(i, "new") for i in (3, 4, 5)]},
          new[3:], "vectors")),
        ("POST", f"{c}/new/points", {"ids": ["x"]}),               # 400
        ("POST", f"{c}/new/points",
         {"ids": ["x"], "vectors": [[1.0] * (DIM + 1)],
          "payloads": [payload(0)]}),                              # 400
        ("POST", f"{c}/other/points",
         {"ids": ["e0", "e1"], "vectors": new[:2].tolist(),
          "payloads": [payload(0), payload(1)]}),
        ("GET", c, None),
        ("GET", f"{c}/prod/count", None),
        ("GET", f"{c}/prod/count?filter=%7B%22class_name%22%3A%22cola%22%7D",
         None),
        ("GET", f"{c}/prod/count?filter=%7Bbad", None),            # 400
        ("POST", f"{c}/prod/count", flt),
        ("POST", f"{c}/prod/count",
         {"filter": {"class_name": "cola"},
          "filter_not": [["is_segmented", True]]}),
        ("POST", f"{c}/prod/count",
         {"filter_should": [["class_name", "cola"],
                            ["class_name", "fanta"]]}),
        ("POST", f"{c}/prod/count", {"filter": {"colour": "red"}}),  # 400
        ("POST", f"{c}/prod/points/search", {"queries": q, "k": 5}),
        ("POST", f"{c}/prod/points/search",
         {"queries": q, "k": 5, "exact": False}),
        ("POST", f"{c}/prod/points/search",
         {"queries": q, "k": 5, "method": "auto", "exact": True}),
        ("POST", f"{c}/prod/points/search",
         {"queries": q, "k": 5, "method": "int8"}),
        ("POST", f"{c}/prod/points/search",
         {"queries": q, "k": 5, "method": "bf16", **flt}),
        ("POST", f"{c}/prod/points/search",
         {"queries": q, "k": 5, "filter_not": [["class_name", "cola"]],
          "with_vectors": True}),
        ("POST", f"{c}/prod/points/search",
         ("binary", {"k": 3, "method": "exact"}, np.asarray(q, np.float32),
          "queries")),
        ("POST", f"{c}/other/points/search",
         {"queries": q, "k": 2, "exact": True}),
        ("POST", f"{c}/prod/points/search",
         {"queries": q, "method": "shardedfoo"}),                  # 400
        ("POST", f"{c}/prod/points/search",
         {"queries": q, "method": "sharded"}),                     # 400
        ("POST", f"{c}/prod/points/search", {"k": 3}),             # 400
        ("POST", f"{c}/nope/points/search", {"queries": q}),       # 404
        ("POST", f"{c}/prod/points/scroll", {"limit": 4}),
        ("POST", f"{c}/prod/points/scroll",
         {"limit": 3, "offset": 2, "with_vectors": True, **flt}),
        ("POST", f"{c}/prod/points/scroll", {"limit": 0}),         # 400
        ("POST", f"{c}/prod/points/retrieve",
         {"ids": ["prod-4", "missing", "prod-1"], "with_vectors": True}),
        ("POST", f"{c}/prod/points/retrieve", {}),                 # 400
        ("POST", f"{c}/prod/points/by-path", {"img_path": "/data/prod/7.png"}),
        ("POST", f"{c}/prod/points/by-path",
         {"img_path": "/data/prod/../prod/8.png", "with_vectors": False}),
        ("POST", f"{c}/prod/points/by-path", {"img_path": "/none.png"}),
        ("POST", f"{c}/prod/points/by-path", {}),                  # 400
        ("POST", f"{c}/prod/points/delete", {"ids": ["prod-3", "nope"]}),
        ("POST", f"{c}/prod/points/delete",
         {"filter": {"class_name": "sprite", "is_segmented": True}}),
        ("POST", f"{c}/prod/points/search", {"queries": q, "k": 5}),
        ("POST", f"{c}/prod/count", {}),
        ("POST", f"{c}/prod/rename", {"new_name": "prod2"}),
        ("POST", f"{c}/prod2/rename", {}),                         # 400
        ("POST", f"{c}/new/rename", {"new_name": "prod2"}),        # 409
        ("GET", f"{c}/prod/count", None),                          # 404
        ("POST", f"{c}/prod2/maintain", {}),
        ("POST", f"{c}/prod2/points/retrieve", {"ids": ["prod-4"]}),
        ("POST", "/snapshot", None),
        ("POST", f"{c}/new/points/delete", {"ids": ["n0"]}),
        ("POST", f"{c}/prod2/maintain", {"force": True}),
        ("DELETE", f"{c}/other", None),
        ("DELETE", f"{c}/other", None),                            # 404
        ("GET", c, None),
        ("GET", "/nowhere", None),                                 # 404
        ("POST", f"{c}/new/points", ("raw", b"{not json")),        # 400
        ("POST", f"{c}/new/points",
         ("raw", (9).to_bytes(4, "little") + b"{}")),              # 400
        ("POST", f"{c}/new/points/search", {"queries": q, "k": 10}),
        ("POST", "/snapshot", None),
    ]


def test_scripted_sequence_matches_jax(pair):
    jb, tb, jroot, troot, vecs = pair
    out = replay(_steps(vecs), [jb, tb])
    codes = sorted({s for s, _ in out})
    assert codes == [200, 400, 404, 409], codes
    # Every endpoint answered 200 at least once.
    assert sum(s == 200 for s, _ in out) >= 40
    jfiles = sorted(p.name for p in jroot.iterdir())
    tfiles = sorted(p.name for p in troot.iterdir())
    assert jfiles == tfiles and "prod2.rbod" in tfiles, (jfiles, tfiles)
    for name in jfiles:
        assert (jroot / name).read_bytes() == (troot / name).read_bytes(), \
            name


def test_warm_endpoint_and_background_warm(tmp_path):
    """``POST .../warm`` and ``serve(warm=True)`` build the serving state
    (the f32 and bf16 mirrors) as the JAX service does; /healthz reports
    warming until the background warm ends."""
    build_root(tmp_path / "root", names=("a", "b"))
    srv = TS.serve(tmp_path / "root", host="127.0.0.1", port=0,
                   device="cpu", warm=True)
    with running(srv) as base:
        deadline = time.time() + 60
        while call("GET", f"{base}/healthz")[1]["warming"]:
            assert time.time() < deadline
            time.sleep(0.05)
        for name in ("a", "b"):
            g = srv.service.store.get(name)
            assert g._dev_f32 is not None and g._dev_bf16 is not None
        status, body, _ = call("POST", f"{base}/collections/a/warm", {})
        assert status == 200 and set(body) == {"seconds"}
        assert call("POST", f"{base}/collections/zz/warm", {})[0] == 404


def test_warm_skips_a_failing_collection(tmp_path, monkeypatch, capsys):
    """A collection whose warm raises is logged and skipped; the others
    warm (JAX ``server.py:150-160``)."""
    from retrieval_based_object_detection_tpu_torch.gallery.store import (
        Gallery,
    )

    build_root(tmp_path / "root", names=("bad", "good"))
    real = Gallery.warm

    def warm(self, *a, **kw):
        if self.name == "bad":
            raise RuntimeError("boom")
        return real(self, *a, **kw)

    monkeypatch.setattr(Gallery, "warm", warm)
    svc = TS.GalleryService(tmp_path / "root", device="cpu")
    svc.warm_async()
    deadline = time.time() + 60
    while svc.warming:
        assert time.time() < deadline
        time.sleep(0.05)
    assert svc.store.get("good")._dev_f32 is not None
    assert svc.store.get("bad")._dev_f32 is None
    assert "warm of 'bad' failed: RuntimeError: boom" in capsys.readouterr().err


def test_mesh_devices_serves_the_sharded_tier(tmp_path):
    """``mesh_devices=-1`` attaches a gallery mesh clamped to the devices
    there are (one on the CPU; eight forced host devices for JAX): exact
    searches over the wire equal the JAX service's, ids and scores."""
    vecs = build_root(tmp_path / "seed", n=60)
    copy_root(tmp_path / "seed", tmp_path / "jax")
    copy_root(tmp_path / "seed", tmp_path / "port")
    js = JS.serve(tmp_path / "jax", host="127.0.0.1", port=0,
                  mesh_devices=-1)
    ts = TS.serve(tmp_path / "port", host="127.0.0.1", port=0,
                  mesh_devices=-1, device="cpu")
    g = ts.service.store.get("prod")
    assert g._gallery_mesh.shape == {"gallery": 1}
    q = (vecs[[2, 9, 30]] + 0.01).tolist()
    with running(js) as jb, running(ts) as tb:
        replay([("POST", "/collections/prod/points/search",
                 {"queries": q, "k": 6}),
                ("POST", "/collections/prod/points/search",
                 {"queries": q, "k": 6, "method": "sharded_exact",
                  "filter": {"class_name": "fanta"}}),
                ("POST", "/collections/prod/points/delete",
                 {"ids": ["prod-2"]}),
                ("POST", "/collections/prod/points/search",
                 {"queries": q, "k": 6})], [jb, tb])
    assert g._shard_view is not None


def test_service_refuses_cuda_without_a_gpu(tmp_path):
    """No fallback: the default device is CUDA, and without a card the
    service does not start."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.GalleryService(tmp_path / "root")
