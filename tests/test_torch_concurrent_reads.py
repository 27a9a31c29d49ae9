"""The port's gallery service under concurrent readers and writers.

The JAX package's storm-versus-serial-oracle design
(tests/test_concurrent_reads.py), on the port's ``GalleryService``
(``device="cpu"``): reader threads search while writer threads upsert and
delete, every answer must equal the serial oracle on a consistent state,
and the end state equals the serial end state. Queries target anchor
points no writer touches, so the right top-1 is the same under every
interleaving: a torn read shows as a wrong id or score. The storm runs
once on each serving tier, with a cold store so the readers race into the
lazy mirror, view and mask builds (one builder under ``Gallery._view_mut``,
the rest wait).
"""

import threading

import numpy as np
import pytest

from retrieval_based_object_detection_tpu_torch.gallery import server as TS
from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
    gallery_mesh,
)
from tests.torch_service_util import call, running

DIM = 16


@pytest.fixture
def svc(tmp_path):
    return TS.GalleryService(tmp_path / "store", device="cpu")


def _mk(svc, name, rng, n=64, dim=DIM):
    svc.create(name, {"dim": dim})
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    svc.upsert(name, {
        "ids": [f"{name}-{i}" for i in range(n)], "vectors": vecs,
        "payloads": [{"data_type": "original_images", "class_name": name,
                      "img_path": f"/{name}/{i}.png"} for i in range(n)]})
    return vecs


def test_searches_overlap_and_collections_do_not_block(svc):
    """Two searches hold one collection's read side together, and a write
    held on one collection does not block a search on another."""
    rng = np.random.default_rng(0)
    vecs = _mk(svc, "a", rng)
    vb = _mk(svc, "b", rng)
    gate = threading.Barrier(2, timeout=10)
    results = []

    def search():
        with svc.read_locked("a"):
            gate.wait()  # both threads inside the read lock at once
            out = svc.search("a", {"queries": [vecs[0].tolist()], "k": 1})
            results.append(out["results"][0][0]["id"])

    ts = [threading.Thread(target=search) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=15)
    assert results == ["a-0", "a-0"]
    with svc.write_locked("a"):
        done = []
        t = threading.Thread(target=lambda: done.append(svc.search(
            "b", {"queries": [vb[3].tolist()], "k": 1})))
        t.start()
        t.join(timeout=10)
        assert done and done[0]["results"][0][0]["id"] == "b-3"


@pytest.mark.parametrize("tier", ["exact", "int8", "int4", "capacity",
                                  "sharded_exact", "sharded_int8"])
def test_storm_matches_serial_oracle(svc, tier):
    rng = np.random.default_rng(1)
    svc.create("s", {"dim": DIM})
    anchors = rng.normal(size=(8, DIM)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    svc.upsert("s", {
        "ids": [f"anchor-{i}" for i in range(8)], "vectors": anchors,
        "payloads": [{"data_type": "original_images", "class_name": "anchor",
                      "img_path": f"/a/{i}.png"} for i in range(8)]})
    if tier.startswith("sharded"):
        svc.store.attach_mesh(gallery_mesh(4, device="cpu"))
    stop = threading.Event()
    errors: list[str] = []
    steps, writers_n, readers_n = 20, 3, 12
    # The capacity tier rescores against bf16 rows: a unit row's cosine
    # with itself is 1 within bf16's 2^-8.
    slack = 2.0 ** -8 if tier == "capacity" else 1e-3

    def writer(seed):
        r = np.random.default_rng(7000 + seed)
        for step in range(steps):
            ids = [f"w{seed}-{step}-{j}" for j in range(4)]
            vecs = r.normal(size=(4, DIM)).astype(np.float32) * 0.1
            try:
                svc.upsert("s", {
                    "ids": ids, "vectors": vecs,
                    "payloads": [{"data_type": "natural_images",
                                  "class_name": f"w{seed}",
                                  "img_path": f"/w/{seed}/{step}/{j}.png"}
                                 for j in range(4)]})
                if step % 3 == 2:
                    svc.delete_points("s", {"ids": ids[:2]})
            except Exception as e:  # noqa: BLE001
                errors.append(f"writer: {type(e).__name__}: {e}")
                return

    def reader(i):
        q = anchors[i % 8]
        for _ in range(25):
            if stop.is_set():
                break
            try:
                out = svc.search("s", {"queries": [q.tolist()], "k": 3,
                                       "method": tier})
                hit = out["results"][0][0]
                if hit["id"] != f"anchor-{i % 8}":
                    errors.append(f"reader{i}: top-1 {hit['id']}")
                    return
                if not 0.99 <= hit["score"] <= 1.0 + slack:
                    errors.append(f"reader{i}: score {hit['score']}")
                    return
                c = svc.count("s", {"filter": {"class_name": "anchor"}})
                if c["count"] != 8:
                    errors.append(f"reader{i}: anchor count {c['count']}")
                    return
            except Exception as e:  # noqa: BLE001
                errors.append(f"reader{i}: {type(e).__name__}: {e}")
                return

    threads = [threading.Thread(target=writer, args=(s,))
               for s in range(writers_n)]
    threads += [threading.Thread(target=reader, args=(i,))
                for i in range(readers_n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    assert not errors, errors[:5]
    expect = 8 + writers_n * sum(4 - (2 if s % 3 == 2 else 0)
                                 for s in range(steps))
    g = svc.store.get("s")
    assert g.count() == expect
    # The serial oracle on the end state: the tier's answer equals the
    # single-device exact search over the same rows.
    q = anchors + 0.01
    got = svc.search("s", {"queries": q.tolist(), "k": 5, "method": tier})
    want = svc.search("s", {"queries": q.tolist(), "k": 5,
                            "method": "exact"})
    for a, b in zip(got["results"], want["results"]):
        assert a[0]["id"] == b[0]["id"]
    if tier.startswith("sharded"):
        assert g._shard_view is not None


def test_topology_storm_with_concurrent_snapshot(svc):
    """Create/delete collections while snapshotting: the snapshot's
    topology re-check converges and never deadlocks."""
    _mk(svc, "stable", np.random.default_rng(2), n=8)
    errors: list[str] = []

    def churn(seed):
        for _ in range(10):
            try:
                svc.create(f"tmp{seed}", {"dim": 8, "force": True})
                svc.delete_collection(f"tmp{seed}")
            except Exception as e:  # noqa: BLE001
                errors.append(f"churn: {type(e).__name__}: {e}")
                return

    def snapshotter():
        for _ in range(5):
            try:
                if "stable" not in svc.snapshot()["saved"]:
                    errors.append("snapshot missed 'stable'")
                    return
            except RuntimeError:
                pass  # the unstable-topology bailout is allowed
            except Exception as e:  # noqa: BLE001
                errors.append(f"snapshot: {type(e).__name__}: {e}")
                return

    ts = [threading.Thread(target=churn, args=(s,)) for s in range(2)]
    ts.append(threading.Thread(target=snapshotter))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "topology storm deadlocked"
    assert not errors, errors[:5]


def test_http_concurrent_search_over_wire(tmp_path):
    """8 wire clients search while one writes over ThreadingHTTPServer."""
    srv = TS.serve(tmp_path / "store", host="127.0.0.1", port=0,
                   device="cpu")
    rng = np.random.default_rng(3)
    with running(srv) as base:
        vecs = _mk(srv.service, "wire", rng, n=32)
        errors: list[str] = []

        def client(i):
            for _ in range(8):
                _, out, _ = call("POST",
                                 f"{base}/collections/wire/points/search",
                                 {"queries": [vecs[i].tolist()], "k": 1})
                if out["results"][0][0]["id"] != f"wire-{i}":
                    errors.append(f"client{i}: {out['results'][0][0]}")
                    return

        def wire_writer():
            for step in range(8):
                call("POST", f"{base}/collections/wire/points",
                     {"ids": [f"x{step}"],
                      "vectors": [(rng.normal(size=DIM) * 0.01).tolist()],
                      "payloads": [{"data_type": "natural_images",
                                    "class_name": "x",
                                    "img_path": f"/x/{step}.png"}]})

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        ts.append(threading.Thread(target=wire_writer))
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors[:5]
