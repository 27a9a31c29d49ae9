"""Dataset directory-contract walker.

The reference's real API is its directory tree (SURVEY.md §1): every stage
reads/writes roots named ``dataset_{jpeg,cropped,segmented,augmented}`` with
the invariant substructure ``{original|natural}_images/<class_name>/<files>``
(e.g. 21_crop_image.py:25-26, 31_clip_embedding_and_save_vector.py:99).
Class identity is carried by the directory name. This module walks that
contract without hardcoding roots. Host-only code, copied from the JAX
package's ``utils/tree.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

IMAGE_TYPES = ("original", "natural")
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")

# Stage roots and the payload flags they imply
# (31_clip_embedding_and_save_vector.py:154-155).
STAGE_ROOTS = {
    "dataset_jpeg": {},
    "dataset_cropped": {"is_segmented": False, "is_augmented": False},
    "dataset_segmented": {"is_segmented": True, "is_augmented": False},
    "dataset_augmented": {"is_segmented": False, "is_augmented": True},
}


@dataclass(frozen=True)
class ImageEntry:
    path: Path
    class_name: str
    img_type: str  # "original" | "natural"


def type_dir(root: str | Path, img_type: str) -> Path:
    if img_type not in IMAGE_TYPES:
        raise ValueError(f"img_type must be one of {IMAGE_TYPES}: {img_type}")
    return Path(root) / f"{img_type}_images"


def list_classes(root: str | Path, img_type: str) -> list[str]:
    """Sorted class names (non-hidden subdirectories), as the reference
    derives them (11_dataset_labeling.py:104-106, 33_run:89)."""
    base = type_dir(root, img_type)
    if not base.is_dir():
        return []
    return sorted(
        d.name for d in base.iterdir()
        if d.is_dir() and not d.name.startswith(".")
    )


def list_images(
    root: str | Path,
    img_type: str,
    class_name: str,
    suffixes: tuple[str, ...] = IMAGE_SUFFIXES,
) -> list[Path]:
    """Sorted image files of one class directory."""
    cls_dir = type_dir(root, img_type) / class_name
    if not cls_dir.is_dir():
        return []
    return sorted(
        f for f in cls_dir.iterdir()
        if f.is_file() and f.suffix.lower() in suffixes
    )


def walk(
    root: str | Path,
    img_type: str,
    classes: list[str] | None = None,
    suffixes: tuple[str, ...] = IMAGE_SUFFIXES,
) -> list[ImageEntry]:
    """All images under root/{img_type}_images, optionally class-filtered."""
    out: list[ImageEntry] = []
    for cls in classes if classes is not None else list_classes(root, img_type):
        for p in list_images(root, img_type, cls, suffixes):
            out.append(ImageEntry(path=p, class_name=cls, img_type=img_type))
    return out


def stage_flags(root: str | Path) -> dict[str, bool]:
    """Payload flags implied by a stage root's basename; unknown roots get
    crop-stage defaults."""
    name = Path(root).name
    flags = STAGE_ROOTS.get(name, {"is_segmented": False, "is_augmented": False})
    return {"is_segmented": False, "is_augmented": False, **flags}
