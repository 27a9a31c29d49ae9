"""Retrieval-as-detection of one upload, in plain PyTorch: frozen copies of
the math the served ``POST /detect`` runs.

upload bytes → PIL decode → letterbox to the serving size (the longer
side scaled, bilinear, padded with the median border colour) → saliency
proposals (border seeds, colour distance, smoothing, threshold, flood
fills, blob boxes, mass shares) → 20% margin → crop and resize to the
tower's size (antialiased bilinear, ``jax.image.scale_and_translate``'s
weights) → CLIP normalisation → the tower (``reference.clip``) → cosine
against the delegate matrix (each class's average member embedding).

``dtype`` sets the precision of the proposal and crop arithmetic: f32 as
served, bf16 in the control.
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def decode(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def letterbox(img: np.ndarray, size: int) -> tuple[np.ndarray, float]:
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
    border = np.concatenate([img[0, :, :], img[-1, :, :], img[:, 0, :],
                             img[:, -1, :]])
    fill = np.median(border, axis=0).astype(img.dtype)
    canvas = np.broadcast_to(fill, (size, size, 3)).copy()
    canvas[:nh, :nw] = resized
    return canvas, scale


# ---------------------------------------------------------------- proposals
def _box_filter(x, win: int, op: str):
    lo = (win - 1) // 2
    hi = win - 1 - lo
    xp = F.pad(x[:, None], (lo, hi, lo, hi),
               value=0.0 if op == "sum" else float("-inf"))
    if op == "sum":
        return F.avg_pool2d(xp, win, stride=1)[:, 0] * (win * win)
    return F.max_pool2d(xp, win, stride=1)[:, 0]


def _saliency(x, border: int, pool: int):
    b = x.shape[0]
    sides = (x[:, :border].reshape(b, -1, 3), x[:, -border:].reshape(b, -1, 3),
             x[:, :, :border].reshape(b, -1, 3),
             x[:, :, -border:].reshape(b, -1, 3))
    ring = torch.cat(sides, dim=1)
    seeds = torch.stack([torch.quantile(s.float(), 0.5, dim=1)
                         for s in (*sides, ring)], dim=1).to(x.dtype)
    seeds = torch.cat([seeds, 0.7 * seeds], dim=1)
    score = torch.full(x.shape[:3], float("inf"), device=x.device,
                       dtype=x.dtype)
    for s in range(seeds.shape[1]):
        d = torch.linalg.vector_norm(x - seeds[:, s][:, None, None, :],
                                     dim=-1)
        score = torch.minimum(score, d)
    return _box_filter(score, pool, "sum") / (pool * pool)


def _boxes(score, rel_threshold: float, min_cells: int, k: int):
    score = score.float()
    b, h, w = score.shape
    flat = score.reshape(b, -1)
    floor = torch.quantile(flat, 0.2, dim=1)
    thresh = floor + rel_threshold * (flat.max(dim=1).values - floor)
    fg = score > thresh[:, None, None]
    rel = torch.clamp(score - thresh[:, None, None], min=0.0)
    ys = torch.arange(h, dtype=torch.float32, device=score.device
                      )[None, :, None].expand(b, h, w)
    xs = torch.arange(w, dtype=torch.float32, device=score.device
                      )[None, None, :].expand(b, h, w)
    iters = max(h, w) // 4 + 2
    claimed = torch.zeros_like(fg)
    blobs, masses = [], []
    for _ in range(k):
        avail = fg & ~claimed
        at = torch.argmax((rel * avail).reshape(b, -1), dim=1)
        py, px = (at // w).float(), (at % w).float()
        blob = (ys == py[:, None, None]) & (xs == px[:, None, None]) & avail
        for _ in range(iters):
            blob = (_box_filter(blob.float(), 9, "max") > 0) & avail
        blobs.append(blob)
        masses.append(torch.sum(rel * blob, dim=(1, 2)))
        claimed = claimed | blob
    total = torch.sum(rel, dim=(1, 2))
    boxes, confs = [], []
    for m, mass in zip(blobs, masses):
        empty = m.reshape(b, -1).sum(dim=1) < min_cells
        box = torch.stack([torch.where(m, xs, 1e9).amin(dim=(1, 2)),
                           torch.where(m, ys, 1e9).amin(dim=(1, 2)),
                           torch.where(m, xs, -1e9).amax(dim=(1, 2)) + 1.0,
                           torch.where(m, ys, -1e9).amax(dim=(1, 2)) + 1.0],
                          dim=1)
        boxes.append(torch.where(empty[:, None], 0.0, box))
        confs.append(torch.where(empty, 0.0,
                                 mass / torch.clamp(total, min=1e-6)))
    boxes, conf = torch.stack(boxes, dim=1), torch.stack(confs, dim=1)
    order = torch.argsort(-torch.stack(masses, dim=1), dim=1, stable=True)
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(conf, 1, order))


def propose(canvases: torch.Tensor, max_boxes: int, dtype=torch.float32):
    """[B, H, W, 3] 0..255 → (boxes [B, K, 4] xyxy canvas px, conf [B, K]):
    a stride-ds average pool to ~160 px, border 8 and pool 9 scaled by ds,
    threshold at 0.35 of the way from the 20th percentile to the peak."""
    x = canvases.to(dtype)
    _, h, w, _ = x.shape
    ds = max(1, max(h, w) // 160)
    if ds > 1:
        x = F.avg_pool2d(x.permute(0, 3, 1, 2), ds, stride=ds
                         ).permute(0, 2, 3, 1)
    score = _saliency(x, max(2, 8 // ds), 9 if ds == 1 else max(3, 9 // ds))
    boxes, conf = _boxes(score, 0.35, max(1, 16 // (ds * ds)), max_boxes)
    if ds > 1:
        limit = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=boxes.device)
        boxes = torch.minimum(torch.clamp(boxes * ds, min=0.0), limit)
    return boxes, conf


# -------------------------------------------------------------- crop, encode
def margin(boxes: torch.Tensor, h: int, w: int, ratio: float = 0.2):
    mx = torch.floor((boxes[..., 2] - boxes[..., 0]) * ratio)
    my = torch.floor((boxes[..., 3] - boxes[..., 1]) * ratio)
    return torch.stack([torch.clamp(boxes[..., 0] - mx, 0, w),
                        torch.clamp(boxes[..., 1] - my, 0, h),
                        torch.clamp(boxes[..., 2] + mx, 0, w),
                        torch.clamp(boxes[..., 3] + my, 0, h)], dim=-1)


def _weights(n_in: int, n_out: int, inv_scale, translation, dtype):
    dev = inv_scale.device
    inv = inv_scale[:, None, None]
    kscale = torch.clamp(inv, min=1.0)
    centres = (torch.arange(n_out, dtype=torch.float64, device=dev)
               + 0.5)[None, None, :]
    inv64 = inv.double()
    sample = (centres * inv64 - translation[:, None, None].double() * inv64
              - 0.5).float()
    x = torch.abs(sample - torch.arange(n_in, dtype=torch.float32,
                                        device=dev)[None, :, None]) / kscale
    wts = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = wts.sum(dim=1, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    wts = torch.where(torch.abs(total) > 1000.0 * eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside, wts, 0.0).to(dtype)


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, size: int,
                dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 3] and one box each → [B, size, size, 3]: antialiased
    bilinear resampling of the box (triangle kernel widened by the
    downscale, weights normalised per output pixel)."""
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(dim=1)
    sy = size / torch.clamp(y2 - y1, min=1.0)
    sx = size / torch.clamp(x2 - x1, min=1.0)
    wy = _weights(images.shape[1], size, 1.0 / sy, -y1 * sy, dtype)
    wx = _weights(images.shape[2], size, 1.0 / sx, -x1 * sx, dtype)
    rows = torch.einsum("bhwc,bhy->bywc", images.to(dtype), wy)
    return torch.einsum("bywc,bwx->byxc", rows, wx).float()


def normalise(crops: torch.Tensor) -> torch.Tensor:
    """0..255 crops → CLIP-normalised."""
    crops = torch.clamp(crops / 255.0, 0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, device=crops.device)
    std = torch.tensor(CLIP_STD, device=crops.device)
    return (crops - mean) / std


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


# ------------------------------------------------------------ whole uploads
def delegates(state: dict, cfg: dict, crops: torch.Tensor, labels,
              n_classes: int, mm=None) -> torch.Tensor:
    """Each class's average member embedding [C, E] (un-normalised) from
    CLIP-normalised gallery crops [N, S, S, 3] and their labels."""
    from reference import clip

    emb = clip.encode_blocks(state, cfg, crops, mm=mm or clip.f32_mm)
    labels = torch.as_tensor(labels, device=emb.device)
    out = torch.zeros(n_classes, emb.shape[1], device=emb.device)
    out.index_add_(0, labels, emb)
    counts = torch.bincount(labels, minlength=n_classes).clamp(min=1)
    return out / counts[:, None]


def answers(uploads: list[bytes], state: dict, cfg: dict,
            delegate_matrix: torch.Tensor, serving_size: int,
            max_boxes: int, device, mm=None, dtype=torch.float32
            ) -> list[dict]:
    """Every proposal of every upload: its box after the margin in the
    upload's pixels (``box``), its confidence and its cosine with each
    class's delegate (``sims`` [K, C])."""
    from reference import clip

    canvases, scales, shapes = [], [], []
    for data in uploads:
        img = decode(data)
        canvas, scale = letterbox(img, serving_size)
        canvases.append(canvas)
        scales.append(scale)
        shapes.append(img.shape[:2])
    x = torch.as_tensor(np.stack(canvases), device=device).float()
    with torch.no_grad(), clip.exact_f32():
        boxes, conf = propose(x, max_boxes, dtype)
        boxes = margin(boxes, x.shape[1], x.shape[2])
        crops = torch.cat([crop_resize(x, boxes[:, k], cfg["image_size"],
                                       dtype)
                           for k in range(boxes.shape[1])])   # [K*B, ...]
        emb = clip.encode_blocks(state, cfg, normalise(crops),
                                 mm=mm or clip.f32_mm)
        sims = unit(emb) @ unit(delegate_matrix.float()).T
    b = x.shape[0]
    sims = sims.reshape(boxes.shape[1], b, -1).permute(1, 0, 2)
    out = []
    for i in range(b):
        h, w = shapes[i]
        lim = torch.tensor([w, h, w, h], dtype=torch.float32)
        box = torch.minimum(torch.clamp(boxes[i].cpu() / scales[i], min=0),
                            lim)
        out.append({"box": box.numpy(), "conf": conf[i].cpu().numpy(),
                    "sims": sims[i].cpu().numpy()})
    return out


def as_served(answer: dict, classes: list[str], conf_threshold: float
              ) -> dict:
    """A reference answer in the served JSON's form: the best box's
    fields at the top and every box whose confidence passes the gate
    (the best always) under ``detections``."""
    dets = []
    for k in range(answer["box"].shape[0]):
        if k and answer["conf"][k] < conf_threshold:
            continue
        c = int(np.argmax(answer["sims"][k]))
        dets.append({"box": [float(v) for v in answer["box"][k]],
                     "confidence": float(answer["conf"][k]),
                     "class_name": classes[c],
                     "similarity": float(answer["sims"][k][c])})
    return {**dets[0], "detections": dets}
