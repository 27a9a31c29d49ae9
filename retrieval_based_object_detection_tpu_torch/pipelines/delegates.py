"""Delegate-vector build stage (the 32_* stage, on the device).

For each requested class × preprocessing case × data_type, gathers the
matching raw vectors from the gallery, computes all four representative
vectors on the gallery's device (``ops.delegates.compute_all_delegates``;
above ``LARGE_CLASS_THRESHOLD`` members the medoid comes from the blocked
kernel, ``ops.medoid.pairwise_distance_sums``) and upserts them with the reference's
deterministic delegate IDs and payload conventions
(32_create_delegate_vector.py:34-42, 104-131).
"""

from __future__ import annotations

import dataclasses

import torch

from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    Filter,
    PRE_CASES,
    Payload,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import Gallery
from retrieval_based_object_detection_tpu_torch.ops import delegates as D
from retrieval_based_object_detection_tpu_torch.ops.medoid import (
    medoid_index,
    pairwise_distance_sums,
)
from retrieval_based_object_detection_tpu_torch.utils.ids import delegate_id

# Above this member count the dense [n, n] medoid matrix (n² · 4 bytes)
# stops being worth materialising; the blocked medoid kernel streams tiles.
LARGE_CLASS_THRESHOLD = 8192


@dataclasses.dataclass
class DelegateBuildResult:
    # (class, case, data_type) -> number of member vectors used (0 = skipped)
    member_counts: dict[tuple[str, str, str], int]
    n_delegates_written: int


def list_classes(gallery: Gallery) -> list[str]:
    """Distinct non-delegate class names (32_create_delegate_vector.py:78-86)."""
    return gallery.distinct("class_name",
                            Filter(must={"is_delegate": False}))


def build_delegates(
    gallery: Gallery,
    classes: list[str] | None = None,
    cases: list[str] | None = None,
    alpha: float = 2.0,
) -> DelegateBuildResult:
    """Build average/centroid/weighted/medoid delegates per class × case
    × data_type.

    A delegate's payload inherits the base fields of its members and sets
    ``is_delegate=True, delegate_type=<strategy>`` (32:34-42). Cases with
    no matching members are skipped (32:133-135). Members are partitioned
    by data_type, as in the JAX package (deterministic where the
    reference stamps whichever data_type Qdrant returns first).
    """
    if classes is None:
        classes = list_classes(gallery)
    if cases is None:
        cases = list(PRE_CASES)

    member_counts: dict[tuple[str, str, str], int] = {}
    written = 0
    for cls in classes:
        for case in cases:
            for data_type in ("original_images", "natural_images"):
                flt = (
                    Filter(must={
                        "class_name": cls,
                        "is_delegate": False,
                        "data_type": data_type,
                    })
                    & Filter.for_case(case)
                )
                members = gallery.vectors_matching(flt)
                member_counts[(cls, case, data_type)] = members.shape[0]
                if members.shape[0] == 0:
                    continue
                recs, _ = gallery.scroll(flt, limit=1)
                base = recs[0].payload
                dev_members = torch.from_numpy(members).to(gallery.device)
                if members.shape[0] > LARGE_CLASS_THRESHOLD:
                    # The dense [n, n] matrix is not worth materialising:
                    # the medoid goes through the blocked kernel (B4), the
                    # O(n) strategies stay plain reductions.
                    outs = D.compute_partial_delegates(dev_members,
                                                       alpha=alpha)
                    outs["medoid"] = dev_members[medoid_index(
                        pairwise_distance_sums(dev_members))]
                else:
                    outs = D.compute_all_delegates(dev_members, alpha=alpha)
                for dtype in D.DELEGATE_TYPES:
                    payload = Payload(
                        data_type=base.data_type,
                        is_cropped=base.is_cropped,
                        is_segmented=base.is_segmented,
                        is_augmented=base.is_augmented,
                        class_name=cls,
                        is_delegate=True,
                        delegate_type=dtype,
                        img_path="",
                    )
                    pid = delegate_id(payload.to_dict(), dtype)
                    gallery.upsert(
                        [pid], outs[dtype].cpu().numpy()[None], [payload])
                    written += 1
    return DelegateBuildResult(
        member_counts=member_counts, n_delegates_written=written
    )
