"""Migrate collections out of a live Qdrant server into the gallery store.

The reference keeps every vector in an external Qdrant Docker container
(02_qdrant_environment_setting.txt:1-8) and talks to it with
qdrant-client. A user switching from the reference to this framework can
pull their existing data straight over Qdrant's public REST API — no
qdrant-client dependency, just the three endpoints the migration needs:

    GET  /collections                       -> collection names
    GET  /collections/{name}                -> vector size / distance
    POST /collections/{name}/points/scroll  -> paged points
         {"limit": N, "offset": <id|null>,
          "with_payload": true, "with_vector": true}
         -> {"result": {"points": [{"id", "payload", "vector"}, ...],
                        "next_page_offset": <id|null>}}

Points land in the gallery via batched columnar upserts (one batch per
scroll page, not the reference's one-HTTP-call-per-image pattern at
31_clip…py:176-179). The 8-field payload schema (31_clip…py:166-175) is
preserved verbatim; payload fields outside the schema are dropped and
counted (the gallery's filter algebra is fixed by the contract). The
destination is a port ``VectorStore`` (its collections on the store's
device) or a ``RemoteVectorStore``. The port of the JAX package's
``pipelines/migrate.py``.
"""

from __future__ import annotations

import json
import sys
import urllib.error
import urllib.request
from dataclasses import dataclass, field

import numpy as np

from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    FIELDS,
    Payload,
)


class QdrantError(RuntimeError):
    pass


def _qdrant_request(method: str, url: str, body: dict | None = None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raise QdrantError(f"qdrant HTTP {e.code} at {url}") from e
    except urllib.error.URLError as e:
        raise QdrantError(f"cannot reach qdrant at {url}: {e.reason}") from e
    if isinstance(out, dict) and out.get("status") not in (None, "ok"):
        raise QdrantError(f"qdrant error at {url}: {out.get('status')}")
    return out.get("result", out) if isinstance(out, dict) else out


def list_qdrant_collections(base_url: str) -> list[str]:
    res = _qdrant_request("GET", f"{base_url.rstrip('/')}/collections")
    return [c["name"] for c in res.get("collections", [])]


def qdrant_collection_info(base_url: str, name: str) -> tuple[int, str]:
    """(dim, distance) of a collection. Handles both the flat single-vector
    config (`params.vectors: {size, distance}`) and named-vector maps
    (takes the sole entry or the one named "default")."""
    res = _qdrant_request(
        "GET", f"{base_url.rstrip('/')}/collections/{name}")
    vectors = res["config"]["params"]["vectors"]
    if "size" not in vectors:  # named-vector map
        key = "default" if "default" in vectors else None
        if key is None:
            if len(vectors) != 1:
                raise QdrantError(
                    f"collection {name!r} has multiple named vectors "
                    f"({sorted(vectors)}); migrate them individually")
            key = next(iter(vectors))
        vectors = vectors[key]
    return int(vectors["size"]), str(vectors.get("distance", "Cosine")).lower()


def _point_vector(point: dict) -> list[float]:
    vec = point.get("vector")
    if isinstance(vec, dict):  # named vectors
        vec = vec.get("default", next(iter(vec.values())) if vec else None)
    if vec is None:
        raise QdrantError(
            f"point {point.get('id')!r} has no vector (scroll must use "
            "with_vector=true)")
    return vec


@dataclass
class MigrationResult:
    collections: list[str] = field(default_factory=list)
    n_points: int = 0
    n_dropped_fields: int = 0
    dropped_fields: set[str] = field(default_factory=set)


def import_collection(store, base_url: str, name: str,
                      dest: str | None = None, batch: int = 1024,
                      result: MigrationResult | None = None,
                      quiet: bool = False,
                      force: bool = False) -> MigrationResult:
    """Copy one Qdrant collection into ``store`` (VectorStore or
    RemoteVectorStore — both expose create_collection/get/upsert).

    Refuses to recreate an existing non-empty destination collection
    unless ``force`` — a migration must never silently wipe local data.
    """
    res = result if result is not None else MigrationResult()
    dest = dest or name
    base = base_url.rstrip("/")
    dim, distance = qdrant_collection_info(base_url, name)
    if dest in store and not force:
        existing = store.get(dest)
        if len(existing) > 0:
            raise QdrantError(
                f"destination collection {dest!r} already holds "
                f"{len(existing)} points; pass force to recreate it")
    gallery = store.create_collection(dest, dim=dim, distance=distance)

    offset = None
    n = 0
    while True:
        body = {"limit": batch, "with_payload": True, "with_vector": True}
        if offset is not None:
            body["offset"] = offset
        page = _qdrant_request(
            "POST", f"{base}/collections/{name}/points/scroll", body)
        points = page.get("points", [])
        if points:
            ids = [str(p["id"]) for p in points]
            vectors = np.asarray([_point_vector(p) for p in points],
                                 dtype=np.float32)
            payloads = []
            for p in points:
                raw = p.get("payload") or {}
                extra = set(raw) - set(FIELDS)
                if extra:
                    res.n_dropped_fields += len(extra)
                    res.dropped_fields |= extra
                payloads.append(Payload.from_dict(raw))
            gallery.upsert(ids, vectors, payloads)
            n += len(points)
            if not quiet:
                print(f"[migrate] {name}: {n} points", file=sys.stderr)
        offset = page.get("next_page_offset")
        if offset is None or not points:
            break

    res.collections.append(dest)
    res.n_points += n
    return res


def import_qdrant(store, base_url: str,
                  collections: list[str] | None = None,
                  batch: int = 1024, quiet: bool = False,
                  force: bool = False) -> MigrationResult:
    """Migrate the named collections from a Qdrant server.

    ``collections=None`` means all; an explicit empty list is an error
    (an empty shell expansion must not silently become a full import).
    """
    if collections is not None and not collections:
        raise QdrantError("empty collection list: name collections to "
                          "migrate, or omit the argument to migrate all")
    names = collections if collections is not None \
        else list_qdrant_collections(base_url)
    res = MigrationResult()
    for name in names:
        import_collection(store, base_url, name, batch=batch, result=res,
                          quiet=quiet, force=force)
    return res
