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

Filters are evaluated host-side against columnar NumPy arrays, producing a
boolean row mask that the device-side search consumes as an additive
penalty. Host-only code, copied from the JAX package's ``gallery/schema.py``
without the snapshot import/export and the lazy path blob, which come with
persistence.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping

import numpy as np

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

DELEGATE_TYPES: tuple[str, ...] = ("average", "centroid", "weighted", "medoid")

# The three preprocessing cases of the experiment grid, exactly as constructed
# at 32_create_delegate_vector.py:104-117 and 33_run_all_experiments.py:122-137.
PRE_CASES: dict[str, dict[str, Any]] = {
    "pre_a": {"is_cropped": True, "is_segmented": False, "is_augmented": False},
    "pre_b": {"is_segmented": True, "is_augmented": False},
    "pre_c": {"is_augmented": True},
}


class UnknownFieldError(KeyError, ValueError):
    """A filter names a field outside the fixed 8-field schema (a KeyError
    for callers that catch that, a ValueError for HTTP boundaries that map
    it to 400)."""


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

    ``must`` rows match every listed field; ``None`` matches rows whose
    field is ``None``. ``must_not`` excludes rows matching ANY of its
    conditions; ``should`` is an OR-group (a row must satisfy every
    ``must`` AND at least one ``should``). ``must_not`` and ``should`` are
    sequences of ``(field, value)`` pairs so one field may repeat
    (``class_name NOT IN {a, b}``); a mapping is accepted and converted.
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
                # A conflicting equality conjunction matches nothing;
                # letting one side win would return the wrong rows.
                raise ValueError(
                    f"contradictory must conditions on {k!r}: "
                    f"{merged[k]!r} AND {v!r} match no rows")
            merged[k] = v
        merged_not = self.must_not + tuple(
            kv for kv in other.must_not if kv not in self.must_not)
        if self.should and other.should:
            # AND of two OR-groups is not representable in this flat model.
            raise ValueError(
                "cannot AND two filters that both carry should groups")
        return Filter(must=merged, must_not=merged_not,
                      should=self.should or other.should)

    def items(self) -> Iterator[tuple[str, Any]]:
        return iter(self.must.items())

    def cache_key(self) -> tuple:
        """Hashable identity for device-mask caches, including the
        negative and should conditions."""
        bykey = lambda kv: (kv[0], repr(kv[1]))  # noqa: E731
        return (tuple(sorted(self.must.items(), key=lambda kv: kv[0])),
                tuple(sorted(self.must_not, key=bykey)),
                tuple(sorted(self.should, key=bykey)))

    @staticmethod
    def for_case(case: str) -> "Filter":
        """Filter for one preprocessing case (pre_a / pre_b / pre_c)."""
        return Filter(must=dict(PRE_CASES[case]))


def _filter_mask(int_cols, int_vals, bool_cols, bool_vals, n: int
                 ) -> np.ndarray:
    """One pass of equality conditions over coded and bool columns."""
    m = np.ones(n, bool)
    for col, val in zip(int_cols, int_vals):
        m &= col[:n] == val
    for col, val in zip(bool_cols, bool_vals):
        m &= col[:n].astype(bool) == bool(val)
    return m


class PayloadColumns:
    """Columnar host-side storage of payloads with vectorised filter eval.

    ``data_type``, ``class_name`` and ``delegate_type`` are
    dictionary-encoded to int32 codes, so equality filters are integer
    compares; ``img_path`` is an object column with a hash index.
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
        if new_capacity < self.capacity:
            raise ValueError(f"cannot shrink {self.capacity} -> {new_capacity}")
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

    def set_rows(self, rows: np.ndarray, payloads: list[Payload]) -> None:
        """Vectorised batch write (``rows`` must not contain duplicates —
        Gallery.upsert dedupes to last-wins)."""
        if len(rows) == 0:
            return
        for row in rows:  # path-index maintenance for overwritten rows
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
        for row, p in zip(rows, payloads):
            self._img_path[row] = p.img_path
            if p.img_path:
                self._path_index[p.img_path] = int(row)
        self.size = max(self.size, int(rows.max()) + 1)

    def get_row(self, row: int) -> Payload:
        kw: dict[str, Any] = {}
        for f in self._CODED:
            code = int(self._cols[f][row])
            kw[f] = self._decode[f][code] if code >= 0 else None
        for f in BOOL_FIELDS:
            kw[f] = bool(self._cols[f][row])
        kw["img_path"] = self._img_path[row] or ""
        return Payload(**kw)

    def row_by_path(self, img_path: str) -> int | None:
        """Row whose stored img_path is exactly ``img_path`` (the last
        writer of a shared path), or None."""
        return self._path_index.get(img_path)

    def path_of(self, row: int) -> str:
        """img_path of one row without building a full Payload."""
        return self._img_path[row] or ""

    def mask(self, flt: Filter | None) -> np.ndarray:
        """Boolean mask over rows [0, size) matching the filter."""
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
        m = _filter_mask(int_cols, int_vals, bool_cols, bool_vals, self.size)
        if path_value is not None:
            pm = np.zeros(self.size, dtype=bool)
            row = self._path_index.get(path_value)
            if row is not None:
                pm[row] = True
            m = m & pm
        # must_not: exclude rows matching ANY negative condition.
        for fieldname, value in flt.must_not:
            if fieldname in BOOL_FIELDS:
                m &= self._cols[fieldname][: self.size] != bool(value)
            elif fieldname == "img_path":
                row = self._path_index.get(value)
                if row is not None:
                    m[row] = False
            else:
                code = self._lookup_code(fieldname, value)
                if code != -2:  # unknown value matches nothing to exclude
                    m &= self._cols[fieldname][: self.size] != code
        # should: at least ONE condition must hold.
        if flt.should:
            sm = np.zeros(self.size, dtype=bool)
            for fieldname, value in flt.should:
                if fieldname in BOOL_FIELDS:
                    sm |= self._cols[fieldname][: self.size] == bool(value)
                elif fieldname == "img_path":
                    row = self._path_index.get(value)
                    if row is not None:
                        sm[row] = True
                else:
                    code = self._lookup_code(fieldname, value)
                    if code != -2:  # unknown value matches no rows
                        sm |= self._cols[fieldname][: self.size] == code
            m = m & sm
        return m
