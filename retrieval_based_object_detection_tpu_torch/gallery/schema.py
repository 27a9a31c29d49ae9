"""Payload schema and filter algebra for the vector gallery.

The 8-field payload contract is fixed by the reference
(31_clip_embedding_and_save_vector.py:166-175):

    data_type      : "original_images" | "natural_images"
    is_cropped     : bool
    is_segmented   : bool
    is_augmented   : bool
    class_name     : str
    is_delegate    : bool
    delegate_type  : None | "average" | "centroid" | "weighted" | "medoid"
    img_path       : str

Filters are evaluated host-side against columnar NumPy arrays (the C++
filter kernel of ``native`` where it builds), producing a boolean row mask
that the device-side search consumes as an additive penalty. Host-only
code, copied from the JAX package's ``gallery/schema.py`` with its snapshot
import/export and the lazy path blob of binary snapshot loads.
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping

import numpy as np


@contextlib.contextmanager
def _gc_paused():
    """Pause the cyclic GC around bulk str/dict materialisations.

    Building a 10M-entry dict of 10M fresh strings triggers repeated
    full collections on allocation thresholds; none of the guarded
    builds create reference cycles. Measured on the deferred
    first-id-op after a 10M-row restart: 40.8 s with GC enabled."""
    if not gc.isenabled():
        yield
        return
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


FIELDS: tuple[str, ...] = (
    "data_type",
    "is_cropped",
    "is_segmented",
    "is_augmented",
    "class_name",
    "is_delegate",
    "delegate_type",
    "img_path",
)

BOOL_FIELDS: frozenset[str] = frozenset(
    {"is_cropped", "is_segmented", "is_augmented", "is_delegate"}
)
STR_FIELDS: frozenset[str] = frozenset(
    {"data_type", "class_name", "delegate_type", "img_path"}
)

DELEGATE_TYPES: tuple[str, ...] = ("average", "centroid", "weighted", "medoid")

# The three preprocessing cases of the experiment grid, exactly as constructed
# at 32_create_delegate_vector.py:104-117 and 33_run_all_experiments.py:122-137.
PRE_CASES: dict[str, dict[str, Any]] = {
    "pre_a": {"is_cropped": True, "is_segmented": False, "is_augmented": False},
    "pre_b": {"is_segmented": True, "is_augmented": False},
    "pre_c": {"is_augmented": True},
}


class UnknownFieldError(KeyError, ValueError):
    """A filter/payload names a field outside the fixed 8-field schema.

    Inherits BOTH KeyError (the historical type — callers catching
    KeyError keep working) and ValueError (so HTTP boundaries that map
    ValueError → 400 classify it as a client error by TYPE, not by
    string-matching the message against the missing-collection
    KeyError → 404 path)."""


@dataclass(frozen=True)
class Payload:
    """One gallery point's metadata (the 8-field contract)."""

    data_type: str
    class_name: str
    img_path: str = ""
    is_cropped: bool = True
    is_segmented: bool = False
    is_augmented: bool = False
    is_delegate: bool = False
    delegate_type: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "data_type": self.data_type,
            "is_cropped": self.is_cropped,
            "is_segmented": self.is_segmented,
            "is_augmented": self.is_augmented,
            "class_name": self.class_name,
            "is_delegate": self.is_delegate,
            "delegate_type": self.delegate_type,
            "img_path": self.img_path,
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Payload":
        return Payload(
            data_type=d.get("data_type", ""),
            is_cropped=bool(d.get("is_cropped", False)),
            is_segmented=bool(d.get("is_segmented", False)),
            is_augmented=bool(d.get("is_augmented", False)),
            class_name=d.get("class_name", ""),
            is_delegate=bool(d.get("is_delegate", False)),
            delegate_type=d.get("delegate_type"),
            img_path=d.get("img_path", ""),
        )


@dataclass(frozen=True)
class Filter:
    """Conjunction of exact-match conditions: ``{field: value}``.

    ``Filter(must={"class_name": "cola", "is_delegate": False})`` matches rows
    where every listed field equals the given value. ``None`` values match
    rows whose field is ``None`` (relevant only for ``delegate_type``).

    ``must_not`` excludes rows matching ANY of its conditions (Qdrant's
    must_not semantics: NOT(c1) AND NOT(c2) …) — trivial on the columnar
    mask path (AND-NOT per condition) and served through the Qdrant
    façade too.

    ``should`` is an OR-group of conditions (Qdrant's should semantics
    when ``must`` is present: a row must satisfy every ``must`` AND at
    least ONE ``should``).

    Because one field may appear in several conditions of the same
    clause (``class_name NOT IN {a, b}`` / ``class_name IN {a, b}`` are
    THE use cases), ``must_not`` and ``should`` are sequences of
    ``(field, value)`` pairs, not mappings — a mapping is accepted and
    converted. Empty means "no constraint". ``must`` stays a mapping:
    two positive equality conditions on one field are a contradiction,
    which JSON objects cannot even carry over the wire.
    """

    must: Mapping[str, Any] = field(default_factory=dict)
    must_not: tuple = ()
    should: tuple = ()

    @staticmethod
    def _pairs(conds) -> tuple:
        """Normalise a mapping or iterable of pairs → ((field, value), …)."""
        if isinstance(conds, Mapping):
            return tuple(conds.items())
        return tuple((str(k), v) for k, v in conds)

    def __post_init__(self) -> None:
        # Normalise the pair-sequence clauses (frozen dataclass: write
        # through object.__setattr__). Order is preserved — AND/OR are
        # commutative but a stable identity keeps cache keys
        # deterministic via sorting.
        object.__setattr__(self, "must_not", self._pairs(self.must_not))
        object.__setattr__(self, "should", self._pairs(self.should))
        for k in (*self.must,
                  *(f for f, _ in self.must_not),
                  *(f for f, _ in self.should)):
            if k not in FIELDS:
                raise UnknownFieldError(
                    f"unknown payload field in filter: {k!r}")

    def __and__(self, other: "Filter") -> "Filter":
        merged = dict(self.must)
        for k, v in other.must.items():
            if k in merged and merged[k] != v:
                # A conflicting equality conjunction matches NOTHING;
                # letting the right side win would silently return the
                # wrong rows. Same fail-loudly stance as the
                # should-AND-should case below.
                raise ValueError(
                    f"contradictory must conditions on {k!r}: "
                    f"{merged[k]!r} AND {v!r} match no rows")
            merged[k] = v
        merged_not = self.must_not + tuple(
            kv for kv in other.must_not if kv not in self.must_not)
        if self.should and other.should:
            # AND of two OR-groups is not representable in this flat
            # model (would need nested boolean clauses); no caller
            # composes filters this way — fail loudly over misfiltering.
            raise ValueError(
                "cannot AND two filters that both carry should groups")
        return Filter(must=merged, must_not=merged_not,
                      should=self.should or other.should)

    def items(self) -> Iterator[tuple[str, Any]]:
        return iter(self.must.items())

    def cache_key(self) -> tuple:
        """Hashable identity for device-mask caches — includes the
        negative and should conditions (a must_not/should filter must
        never collide with its positive twin)."""
        bykey = lambda kv: (kv[0], repr(kv[1]))  # noqa: E731
        return (tuple(sorted(self.must.items(), key=lambda kv: kv[0])),
                tuple(sorted(self.must_not, key=bykey)),
                tuple(sorted(self.should, key=bykey)))

    # ------------------------------------------------------------- wire
    # THE one encoder/decoder pair for the native REST wire (used by the
    # Python client AND the Qdrant façade's forwarding) — a new clause
    # kind added here reaches every path, instead of being forwarded at
    # some call sites and dropped at others.
    def to_wire(self) -> dict:
        """Native-wire body fields: ``filter`` (must, a JSON object),
        ``filter_not`` / ``filter_should`` ([[field, value], …])."""
        out: dict = {}
        if self.must:
            out["filter"] = dict(self.must)
        if self.must_not:
            out["filter_not"] = [list(kv) for kv in self.must_not]
        if self.should:
            out["filter_should"] = [list(kv) for kv in self.should]
        return out

    @staticmethod
    def from_wire(body: Mapping) -> "Filter | None":
        """Inverse of ``to_wire``; also accepts the legacy dict shape
        for ``filter_not``. Returns None when no clause is present."""
        must = body.get("filter")
        mnot = body.get("filter_not")
        should = body.get("filter_should")
        if not must and not mnot and not should:
            return None
        return Filter(must=must or {}, must_not=mnot or (),
                      should=should or ())

    @staticmethod
    def for_case(case: str) -> "Filter":
        """Filter for one preprocessing case (pre_a / pre_b / pre_c)."""
        return Filter(must=dict(PRE_CASES[case]))


class PayloadColumns:
    """Columnar host-side storage of payloads with vectorised filter eval.

    Low-cardinality string fields (``data_type``, ``class_name``,
    ``delegate_type``) are dictionary-encoded to int32 codes so equality
    filters are integer compares; ``img_path`` is a high-cardinality object
    column queried only by exact match (33_run_all_experiments.py:96-110),
    backed by a hash map for O(1) lookup.
    """

    _CODED = ("data_type", "class_name", "delegate_type")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.size = 0
        self._codes: dict[str, dict[Any, int]] = {f: {} for f in self._CODED}
        self._decode: dict[str, list[Any]] = {f: [] for f in self._CODED}
        self._cols: dict[str, np.ndarray] = {}
        for f in self._CODED:
            self._cols[f] = np.full(capacity, -1, dtype=np.int32)
        for f in BOOL_FIELDS:
            self._cols[f] = np.zeros(capacity, dtype=bool)
        self._img_path = np.empty(capacity, dtype=object)
        self._path_index: dict[str, int] = {}
        # Lazy path materialisation (binary snapshot loads): the raw
        # NUL-separated utf-8 blob is held here and split into
        # ``_img_path`` + ``_path_index`` only on first path access —
        # the two dict/object-array builds cost ~1 s/1M rows.
        self._paths_lazy = None  # bytes | memoryview | None
        # Writes that land while the blob is still lazy (the row-indexed
        # delta replay) defer their path-index maintenance here
        # (row -> new path, None = cleared); applied by _ensure_paths.
        self._pending_paths: dict[int, Any] = {}
        # NUL positions inside the lazy blob — lets single rows read
        # their path as a slice+decode without the full split+dict
        # build (one 0.4 GB pass at 10M instead of ~20 s of dict
        # building; built on the first per-row read, dropped once the
        # blob fully materialises).
        self._path_offs = None  # np.ndarray[int64] | None

    def _row_path_lazy(self, row: int):
        """One row's path while the blob is still lazy (overlay first,
        then a slice of the blob via the NUL-offset table). Returns
        None for rows past the blob with no overlay entry (cannot
        happen through the write paths, which always record overlays).
        """
        if row in self._pending_paths:
            return self._pending_paths[row]
        blob = self._paths_lazy
        if self._path_offs is None:
            self._path_offs = np.flatnonzero(
                np.frombuffer(blob, np.uint8) == 0)
        offs = self._path_offs
        n0 = len(offs) + 1  # rows covered by the blob
        if row >= n0:
            return None
        lo = int(offs[row - 1]) + 1 if row else 0
        hi = int(offs[row]) if row < len(offs) else len(blob)
        return bytes(blob[lo:hi]).decode("utf-8")

    def _ensure_paths(self) -> None:
        blob = self._paths_lazy
        if blob is None:
            return
        self._paths_lazy = None
        self._path_offs = None
        pending = self._pending_paths
        self._pending_paths = {}
        # The blob covers the snapshot's rows only — ``size`` may have
        # grown past it through lazy-mode appends (all recorded in
        # ``pending``).
        with _gc_paused():
            paths = bytes(blob).decode("utf-8").split("\x00")
            n0 = min(len(paths), self.size)
            index: dict[str, int] = {}
            if n0:
                self._img_path[:n0] = np.array(paths, dtype=object)[:n0]
                index = dict(zip(paths[:n0], range(n0)))
                index.pop("", None)
            self._path_index = index

        def _apply(row: int, p) -> None:
            old = self._img_path[row]
            if old is not None and self._path_index.get(old) == row:
                del self._path_index[old]
            self._img_path[row] = p
            if p:
                self._path_index[p] = row

        # Clears first, then sets: within one overlay a path may migrate
        # from a tombstoned row to a re-added one.
        for row, p in pending.items():
            if not p:
                _apply(row, p)
        for row, p in pending.items():
            if p:
                _apply(row, p)

    def _encode(self, fieldname: str, value: Any) -> int:
        codes = self._codes[fieldname]
        if value not in codes:
            codes[value] = len(codes)
            self._decode[fieldname].append(value)
        return codes[value]

    def _lookup_code(self, fieldname: str, value: Any) -> int:
        """Code for filtering; -2 means 'matches nothing'."""
        return self._codes[fieldname].get(value, -2)

    def grow(self, new_capacity: int) -> None:
        # NB: growth is lazy-safe — the path blob stays unsplit (the
        # object-array copy moves Nones; pending overlay rows survive).
        assert new_capacity >= self.capacity
        if new_capacity == self.capacity:
            return
        for f in self._CODED:
            col = np.full(new_capacity, -1, dtype=np.int32)
            col[: self.capacity] = self._cols[f]
            self._cols[f] = col
        for f in BOOL_FIELDS:
            col = np.zeros(new_capacity, dtype=bool)
            col[: self.capacity] = self._cols[f]
            self._cols[f] = col
        img = np.empty(new_capacity, dtype=object)
        img[: self.capacity] = self._img_path
        self._img_path = img
        self.capacity = new_capacity

    def set_row(self, row: int, payload: Payload) -> None:
        self._ensure_paths()
        old_path = self._img_path[row] if row < self.size else None
        if old_path is not None and self._path_index.get(old_path) == row:
            del self._path_index[old_path]
        for f in self._CODED:
            self._cols[f][row] = self._encode(f, getattr(payload, f))
        for f in BOOL_FIELDS:
            self._cols[f][row] = getattr(payload, f)
        self._img_path[row] = payload.img_path
        if payload.img_path:
            self._path_index[payload.img_path] = row
        self.size = max(self.size, row + 1)

    def set_rows(self, rows: np.ndarray, payloads: list[Payload]) -> None:
        """Vectorised batch write: one fancy-indexed assignment per column
        instead of a Python loop of per-row scalar stores (``rows`` must
        not contain duplicates — Gallery.upsert dedupes to last-wins)."""
        if len(rows) == 0:
            return
        lazy = self._paths_lazy is not None
        max_row = int(rows.max())
        if not lazy:
            # Path-index maintenance for overwritten rows.
            for row in rows:
                if row < self.size:
                    old = self._img_path[row]
                    if old is not None and self._path_index.get(old) == row:
                        del self._path_index[old]
        for f in self._CODED:
            codes = np.fromiter(
                (self._encode(f, getattr(p, f)) for p in payloads),
                dtype=np.int32, count=len(payloads))
            self._cols[f][rows] = codes
        for f in BOOL_FIELDS:
            vals = np.fromiter((getattr(p, f) for p in payloads),
                               dtype=bool, count=len(payloads))
            self._cols[f][rows] = vals
        if lazy:
            # Defer the path writes: splitting the whole blob to patch a
            # few rows would re-pay the restart cost the lazy load
            # deferred (the row-indexed delta replay lands here).
            for row, p in zip(rows, payloads):
                self._pending_paths[int(row)] = p.img_path
        else:
            for row, p in zip(rows, payloads):
                self._img_path[row] = p.img_path
                if p.img_path:
                    self._path_index[p.img_path] = int(row)
        self.size = max(self.size, max_row + 1)

    def get_row(self, row: int) -> Payload:
        kw: dict[str, Any] = {}
        for f in self._CODED:
            code = int(self._cols[f][row])
            kw[f] = self._decode[f][code] if code >= 0 else None
        for f in BOOL_FIELDS:
            kw[f] = bool(self._cols[f][row])
        if self._paths_lazy is not None:
            # Per-row slice off the lazy blob: materialising search/
            # retrieve RESULTS must not pay the full path-index build
            # (~20 s at 10M rows right after a restart).
            kw["img_path"] = self._row_path_lazy(row) or ""
        else:
            kw["img_path"] = self._img_path[row] or ""
        return Payload(**kw)

    def row_by_path(self, img_path: str) -> int | None:
        self._ensure_paths()
        return self._path_index.get(img_path)

    def path_of(self, row: int) -> str:
        """img_path of one row without materialising a full Payload
        (the resolved-path index build touches every row)."""
        if self._paths_lazy is not None:
            return self._row_path_lazy(row) or ""
        return self._img_path[row] or ""

    def clear_path(self, row: int) -> None:
        """Drop one row's path (tombstoned rows must vanish from
        exact-path lookup immediately, ahead of physical compaction)."""
        if self._paths_lazy is not None:
            self._pending_paths[row] = None
            return
        p = self._img_path[row]
        if p is not None and self._path_index.get(p) == row:
            del self._path_index[p]
        self._img_path[row] = None

    def mask(self, flt: Filter | None) -> np.ndarray:
        """Boolean mask over rows [0, size) matching the filter.

        Coded/bool equality conjunctions are evaluated by the C++ one-pass
        kernel (native.filter_mask) when available; img_path predicates
        resolve through the O(1) hash index either way.
        """
        if flt is None:
            return np.ones(self.size, dtype=bool)
        int_cols, int_vals, bool_cols, bool_vals = [], [], [], []
        path_value = None
        for fieldname, value in flt.items():
            if fieldname in BOOL_FIELDS:
                bool_cols.append(self._cols[fieldname])
                bool_vals.append(bool(value))
            elif fieldname == "img_path":
                path_value = value
            else:
                int_cols.append(self._cols[fieldname])
                int_vals.append(self._lookup_code(fieldname, value))

        if int_cols or bool_cols:
            from retrieval_based_object_detection_tpu_torch import native

            m = native.filter_mask(int_cols, int_vals,
                                   bool_cols, bool_vals, self.size)
        else:
            m = np.ones(self.size, dtype=bool)
        if path_value is not None:
            self._ensure_paths()
            pm = np.zeros(self.size, dtype=bool)
            row = self._path_index.get(path_value)
            if row is not None:
                pm[row] = True
            m = m & pm
        # must_not: exclude rows matching ANY negative condition
        # (AND-NOT per condition on the columns; one field may appear
        # in several conditions — class_name NOT IN {a, b}).
        for fieldname, value in getattr(flt, "must_not", ()):
            if fieldname in BOOL_FIELDS:
                m &= self._cols[fieldname][: self.size] != bool(value)
            elif fieldname == "img_path":
                self._ensure_paths()
                row = self._path_index.get(value)
                if row is not None:
                    m = m.copy()
                    m[row] = False
            else:
                code = self._lookup_code(fieldname, value)
                if code != -2:  # unknown value matches nothing to exclude
                    m &= self._cols[fieldname][: self.size] != code
        # should: at least ONE condition must hold (OR-group ANDed with
        # the rest — Qdrant's should semantics under a must clause).
        should = getattr(flt, "should", ())
        if should:
            sm = np.zeros(self.size, dtype=bool)
            for fieldname, value in should:
                if fieldname in BOOL_FIELDS:
                    sm |= self._cols[fieldname][: self.size] == bool(value)
                elif fieldname == "img_path":
                    self._ensure_paths()
                    row = self._path_index.get(value)
                    if row is not None:
                        sm[row] = True
                else:
                    code = self._lookup_code(fieldname, value)
                    if code != -2:  # unknown value matches no rows
                        sm |= self._cols[fieldname][: self.size] == code
            m = m & sm
        return m

    def export_columns(self, n: int) -> dict:
        """Columnar snapshot payload (base64 numpy buffers + decode
        tables) — serialising 1M rows this way beats building 1M per-row
        payload dicts by ~10× (persist format v2)."""
        self._ensure_paths()
        import base64

        return {
            "coded": {
                f: {
                    "codes": base64.b64encode(
                        self._cols[f][:n].tobytes()).decode("ascii"),
                    "decode": self._decode[f],
                }
                for f in self._CODED
            },
            "bools": {
                f: base64.b64encode(
                    np.packbits(self._cols[f][:n])).decode("ascii")
                for f in BOOL_FIELDS
            },
            "img_path": [p or "" for p in self._img_path[:n]],
        }

    def export_rows(self, rows: np.ndarray) -> dict:
        """Columnar export of an ARBITRARY row subset, in the same
        structure as ``export_columns`` (incremental delta snapshots
        serialise only the rows changed since the last save). Paths
        come through ``path_of`` — splitting the whole NUL blob +
        building the path dict (~20 s at 10M) to export a handful of
        dirty rows would blow the ms-scale delta-save shutdown budget
        on a lazily restarted gallery."""
        import base64

        rows = np.asarray(rows, np.int64)
        return {
            "coded": {
                f: {
                    "codes": base64.b64encode(
                        np.ascontiguousarray(
                            self._cols[f][rows]).tobytes()).decode("ascii"),
                    "decode": self._decode[f],
                }
                for f in self._CODED
            },
            "bools": {
                f: base64.b64encode(
                    np.packbits(self._cols[f][rows])).decode("ascii")
                for f in BOOL_FIELDS
            },
            "img_path": [self.path_of(int(r)) for r in rows],
        }

    def export_binary(self, n: int) -> tuple[dict, list[tuple[str, bytes]]]:
        """(header, [(section_name, raw_bytes)]) for the format-3 binary
        snapshot container: coded columns as raw int32, bools packbit,
        paths as one NUL-separated utf-8 blob. No base64, no JSON body —
        the loader slices these zero-copy from the snapshot mmap and
        materialises the path index lazily (~1 s/1M rows saved on
        restart)."""
        self._ensure_paths()
        sections: list[tuple[str, bytes]] = []
        for f in self._CODED:
            sections.append(
                (f"codes_{f}",
                 np.ascontiguousarray(self._cols[f][:n]).tobytes()))
        for f in sorted(BOOL_FIELDS):
            sections.append(
                (f"bools_{f}", np.packbits(self._cols[f][:n]).tobytes()))
        paths = "\x00".join((p or "") for p in self._img_path[:n])
        sections.append(("paths", paths.encode("utf-8")))
        return {"decode": {f: self._decode[f] for f in self._CODED}}, sections

    @classmethod
    def import_binary(cls, header: dict, get_section, n: int
                      ) -> "PayloadColumns":
        """Rebuild from format-3 sections. ``get_section(name)`` returns
        a buffer (bytes or a memoryview over the snapshot mmap — path
        bytes are then only paged in when a path is first touched)."""
        out = cls(max(n, 1))
        for f in cls._CODED:
            out._cols[f][:n] = np.frombuffer(
                get_section(f"codes_{f}"), np.int32, count=n)
            out._decode[f] = list(header["decode"][f])
            out._codes[f] = {v: i for i, v in enumerate(out._decode[f])}
        for f in BOOL_FIELDS:
            out._cols[f][:n] = np.unpackbits(
                np.frombuffer(get_section(f"bools_{f}"), np.uint8),
                count=n).astype(bool)
        out._paths_lazy = get_section("paths")
        out.size = n
        return out

    @classmethod
    def import_columns(cls, data: dict, n: int) -> "PayloadColumns":
        import base64

        out = cls(max(n, 1))
        for f in cls._CODED:
            spec = data["coded"][f]
            codes = np.frombuffer(
                base64.b64decode(spec["codes"]), np.int32)[:n].copy()
            out._cols[f][:n] = codes
            out._decode[f] = list(spec["decode"])
            out._codes[f] = {v: i for i, v in enumerate(out._decode[f])}
        for f in BOOL_FIELDS:
            bits = np.unpackbits(
                np.frombuffer(base64.b64decode(data["bools"][f]), np.uint8),
                count=n).astype(bool)
            out._cols[f][:n] = bits
        paths = data["img_path"]
        # dict(zip(...)) runs the insert loop in C — at 1M rows the
        # per-row Python loop here was the single biggest load cost
        # (~1.2 s of a 3 s mmap load; profiled).
        out._img_path[:n] = np.array(paths, dtype=object)[:n] \
            if paths else ""
        index = dict(zip(paths, range(n)))
        index.pop("", None)
        index.pop(None, None)
        out._path_index = index
        out.size = n
        return out

    def compact(self, keep: np.ndarray) -> np.ndarray:
        """Keep only rows where ``keep`` is True; returns old→new row map."""
        self._ensure_paths()
        assert keep.shape == (self.size,)
        new_rows = np.cumsum(keep) - 1
        n_new = int(keep.sum())
        for f in self._CODED:
            self._cols[f][:n_new] = self._cols[f][: self.size][keep]
            self._cols[f][n_new : self.size] = -1
        for f in BOOL_FIELDS:
            self._cols[f][:n_new] = self._cols[f][: self.size][keep]
            self._cols[f][n_new : self.size] = False
        kept_paths = self._img_path[: self.size][keep]
        self._img_path[:n_new] = kept_paths
        self._img_path[n_new : self.size] = None
        self.size = n_new
        self._path_index = {
            p: i for i, p in enumerate(self._img_path[:n_new]) if p
        }
        return new_rows
