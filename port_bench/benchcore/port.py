"""The port's objects that the harness makes from a configuration file."""

from __future__ import annotations


def clip_config(cfg: dict):
    """The port's ``CLIPVisionConfig`` of a configuration file."""
    from retrieval_based_object_detection_tpu_torch.models.clip import model

    return model.CLIPVisionConfig(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        width=cfg["width"], layers=cfg["layers"], heads=cfg["heads"],
        embed_dim=cfg["embed_dim"], mlp_ratio=cfg["mlp_ratio"])
