"""Augmentation stage (the 23_* stage): ~26 variants per segmented image.

Grid (23_augmentation.py:10-13): 6 brightness rates, 11 rotations with
expanded transparent canvas, 3 noise types × 3 levels. Filename postfixes
follow the reference scheme BYTE-FOR-BYTE (23:66-73, 86-112) — including
its ``int()`` float truncation, so rates 1.2/0.9/0.8 yield p19/n9/n19,
NOT p20/n10/n20 (``int((1.2-1)*100) == 19``; keeping the quirk keeps the
trees interchangeable with reference-produced artifacts):

  <stem>_brightness_{p19,p10,p5,n5,n9,n19}<ext>
  <stem>_rot{30..330}<ext>
  <stem>_{gaussian,blur,snp}noise_{1,2,3}<ext>

Bug fixed vs reference: 23 iterates noise type ``'s&p'`` but dispatches on
``'snp'`` (23:12 vs 23:108), so its salt&pepper variants are never written.
Here the type key is ``snp`` end-to-end and the variants ARE produced —
26 files per input instead of the reference's effective 23.

The pixel math runs on ``device`` (``ops.image``). The noise of each
image comes from its own CPU ``torch.Generator``, seeded from (seed, the
image's index), so a re-run writes the same files whatever the thread
schedule and whichever device ran it. The JAX package draws from threefry
keys instead: the noise variants are the port's own bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.ops import image as I
from retrieval_based_object_detection_tpu_torch.utils import tree
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


@dataclasses.dataclass
class AugmentConfig:
    src_root: str = "dataset_segmented"
    dst_root: str = "dataset_augmented"
    img_type: str = "original"
    classes: list[str] | None = None
    brightness_rates: tuple[float, ...] = I.BRIGHTNESS_RATES
    rotation_angles: tuple[int, ...] = I.ROTATION_ANGLES
    noise_types: tuple[str, ...] = I.NOISE_TYPES
    noise_levels: tuple[float, ...] = I.NOISE_LEVELS
    seed: int = 0


def postfix_num(val) -> str:
    """'+20'→'p20', '-5'→'n5', '30'→'30' (23_augmentation.py:66-73)."""
    sval = str(val)
    if sval.startswith("+"):
        return "p" + sval[1:]
    if sval.startswith("-"):
        return "n" + sval[1:]
    return sval


def _brightness_suffix(rate: float) -> str:
    # int() truncation kept deliberately (reference 23:86): 1.2 → p19.
    delta = int((rate - 1) * 100)
    return f"brightness_{postfix_num(f'{delta:+d}')}"


def _rotation_suffix(angle: int) -> str:
    return f"rot{postfix_num(angle)}"


def _noise_suffix(ntype: str, level: float) -> str:
    return f"{ntype}noise_{postfix_num(int(level * 100))}"


def variant_names(stem: str, ext: str, cfg: AugmentConfig) -> list[str]:
    """The full expected output filename list for one input image —
    derived from the SAME suffix helpers ``augment_array`` uses, so the
    expected list can never drift from the files actually written."""
    names = [f"{stem}_{_brightness_suffix(r)}{ext}"
             for r in cfg.brightness_rates]
    names += [f"{stem}_{_rotation_suffix(a)}{ext}"
              for a in cfg.rotation_angles]
    names += [f"{stem}_{_noise_suffix(t, lv)}{ext}"
              for t in cfg.noise_types for lv in cfg.noise_levels]
    return names


def image_generator(seed: int, idx: int) -> torch.Generator:
    """The CPU generator of the ``idx``-th input of a run seeded ``seed``."""
    state = np.random.SeedSequence((seed, idx)).generate_state(1, np.uint64)
    return torch.Generator(device="cpu").manual_seed(int(state[0]))


def _to_uint8(x: torch.Tensor) -> np.ndarray:
    return torch.clamp(x, 0, 255).to(torch.uint8).cpu().numpy()


def augment_array(img: np.ndarray, cfg: AugmentConfig,
                  generator: torch.Generator,
                  device: str | torch.device = "cuda"
                  ) -> list[tuple[str, np.ndarray]]:
    """All variants of one [H, W, C] uint8 image → [(name_suffix, array)].

    Suffix excludes stem/ext; caller builds filenames. RGBA alpha is kept
    and transformed alongside RGB (brightness keeps it like PIL does;
    rotation fills with transparent). The noise variants draw from
    ``generator`` in grid order.
    """
    x = torch.tensor(np.asarray(img), device=resolve_device(device)
                     ).to(torch.float32)
    out: list[tuple[str, np.ndarray]] = []

    for rate in cfg.brightness_rates:
        out.append((_brightness_suffix(rate),
                    _to_uint8(I.brightness(x, rate))))

    for angle in cfg.rotation_angles:
        out.append((_rotation_suffix(angle),
                    _to_uint8(I.rotate_expand(x, float(angle)))))

    for ntype in cfg.noise_types:
        for level in cfg.noise_levels:
            if ntype == "gaussian":
                arr = I.gaussian_noise(x, level, generator)
            elif ntype == "blur":
                arr = I.gaussian_blur(x, int(2 * int(level * 100)))
            elif ntype == "snp":
                arr = I.salt_pepper(x, level, generator)
            else:
                continue
            out.append((_noise_suffix(ntype, level), _to_uint8(arr)))
    return out


@dataclasses.dataclass
class AugmentResult:
    n_inputs: int
    n_written: int
    n_failed: int


def run_augment(cfg: AugmentConfig,
                device: str | torch.device = "cuda") -> AugmentResult:
    from PIL import Image

    from retrieval_based_object_detection_tpu_torch.utils.loader import (
        parallel_map,
    )

    dev = resolve_device(device)
    classes = (cfg.classes if cfg.classes is not None
               else tree.list_classes(cfg.src_root, cfg.img_type))
    work: list[tuple[int, object, object]] = []  # (idx, img_path, dst_dir)
    idx = 0
    for cls in classes:
        dst_dir = tree.type_dir(cfg.dst_root, cfg.img_type) / cls
        dst_dir.mkdir(parents=True, exist_ok=True)
        for img_path in tree.list_images(cfg.src_root, cfg.img_type, cls):
            idx += 1
            work.append((idx, img_path, dst_dir))

    def one(item) -> tuple[int, int, int]:
        # Per-image decode→augment→encode fans out over the shared host
        # pool (~26 PIL encodes per image is the slowest host stage at
        # scale); the per-image generators keep outputs identical to the
        # sequential order whatever the thread schedule.
        i, img_path, dst = item
        try:
            with Image.open(img_path) as im:
                arr = np.asarray(im.convert("RGBA"))
        except Exception:
            return 0, 0, 1
        ext = img_path.suffix.lower()
        jpeg_out = ext in (".jpg", ".jpeg")
        wrote = failed = 0
        for suffix, out_arr in augment_array(
                arr, cfg, image_generator(cfg.seed, i), dev):
            try:
                img = Image.fromarray(out_arr)
                if jpeg_out:
                    # JPEG has no alpha; composite like the visual
                    # result (augment inputs are normally RGBA PNGs,
                    # but crops feed through as JPEGs too).
                    img = img.convert("RGB")
                img.save(dst / f"{img_path.stem}_{suffix}{ext}")
                wrote += 1
            except Exception:
                failed += 1
        return 1, wrote, failed

    results = parallel_map(one, work)
    n_in = sum(r[0] for r in results)
    n_out = sum(r[1] for r in results)
    n_fail = sum(r[2] for r in results)
    return AugmentResult(n_inputs=n_in, n_written=n_out, n_failed=n_fail)
