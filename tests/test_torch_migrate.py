"""Port parity: ``pipelines/migrate.py`` against the JAX package's.

``import_qdrant`` from the port's Qdrant façade into a port store equals
the JAX import from the JAX façade into a JAX store (collections, ids,
vectors, payloads, dims, distances), over copies of one root. Both
importers read the same fake Qdrant server (int and string ids, named
vectors, out-of-schema payload fields) into equal stores, and the port
imports into a ``RemoteVectorStore`` as into a local one. Oracles:
tests/test_qdrant_compat.py, tests/test_migrate.py.
"""

import numpy as np
import pytest

from retrieval_based_object_detection_tpu.gallery import server as JS
from retrieval_based_object_detection_tpu.gallery.store import (
    VectorStore as JStore,
)
from retrieval_based_object_detection_tpu.pipelines import migrate as jmig
from retrieval_based_object_detection_tpu_torch.gallery import server as TS
from retrieval_based_object_detection_tpu_torch.gallery.client import (
    RemoteVectorStore,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    VectorStore as TStore,
)
from retrieval_based_object_detection_tpu_torch.pipelines import migrate as tmig
from tests.test_migrate import qdrant  # noqa: F401  (the fake server)
from tests.torch_service_util import build_root, copy_root, running


def _dump(store):
    out = {}
    for name, _ in store.list_collections():
        g = store.get(name)
        recs = g.scroll_all(with_vectors=True)
        out[name] = (g.dim, g.distance,
                     [(r.id, r.payload.to_dict(), r.vector.tolist())
                      for r in recs])
    return out


def test_import_from_facades_matches_jax(tmp_path):
    build_root(tmp_path / "seed", n=45, dim=8, names=("prod", "other"))
    copy_root(tmp_path / "seed", tmp_path / "jax")
    copy_root(tmp_path / "seed", tmp_path / "port")
    js = JS.serve(tmp_path / "jax", host="127.0.0.1", port=0, api="qdrant")
    ts = TS.serve(tmp_path / "port", host="127.0.0.1", port=0, api="qdrant",
                  device="cpu")
    with running(js) as jb, running(ts) as tb:
        jdest, tdest = JStore(), TStore(device="cpu")
        jres = jmig.import_qdrant(jdest, jb, batch=10, quiet=True)
        tres = tmig.import_qdrant(tdest, tb, batch=10, quiet=True)
        assert (tres.collections, tres.n_points) == \
            (jres.collections, jres.n_points) == (["other", "prod"], 90)
        assert _dump(tdest) == _dump(jdest)
        # The source façade's own rows, unchanged by the round trip.
        src = ts.service.store
        assert _dump(tdest) == _dump(src)
        with pytest.raises(tmig.QdrantError, match="already holds"):
            tmig.import_collection(tdest, tb, "prod", quiet=True)
        with pytest.raises(tmig.QdrantError, match="empty collection list"):
            tmig.import_qdrant(tdest, tb, collections=[])


def test_import_from_fake_qdrant_matches_jax(qdrant):  # noqa: F811
    base = qdrant[0]
    jdest, tdest = JStore(), TStore(device="cpu")
    jres = jmig.import_qdrant(jdest, base, batch=3, quiet=True)
    tres = tmig.import_qdrant(tdest, base, batch=3, quiet=True)
    assert (tres.collections, tres.n_points, tres.n_dropped_fields,
            tres.dropped_fields) == (jres.collections, jres.n_points,
                                     jres.n_dropped_fields,
                                     jres.dropped_fields)
    assert _dump(tdest) == _dump(jdest)
    assert tmig.list_qdrant_collections(base) == \
        jmig.list_qdrant_collections(base)
    for name in tres.collections:
        assert tmig.qdrant_collection_info(base, name) == \
            jmig.qdrant_collection_info(base, name)


def test_import_into_a_remote_store(tmp_path):
    """The closed loop into a port service: façade → ``RemoteVectorStore``
    equals façade → local store."""
    build_root(tmp_path / "seed", n=30, dim=8)
    src = TS.serve(tmp_path / "seed", host="127.0.0.1", port=0,
                   api="qdrant", device="cpu")
    dst = TS.serve(tmp_path / "dst", host="127.0.0.1", port=0, device="cpu")
    with running(src) as sb, running(dst) as db:
        remote = RemoteVectorStore(db)
        res = tmig.import_qdrant(remote, sb, batch=7, quiet=True)
        local = TStore(device="cpu")
        tmig.import_qdrant(local, sb, batch=7, quiet=True)
        assert res.n_points == 30
        assert _dump(dst.service.store) == _dump(local)
        g = remote.get("prod")
        q = np.asarray(g.retrieve(["prod-3"])[0].vector)
        assert g.search(q, k=1)[0][0].id == "prod-3"
