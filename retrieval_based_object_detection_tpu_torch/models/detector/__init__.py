"""Detectors for the auto-labeling stage (the YOLO role of
11_dataset_labeling.py): the weight-free ``saliency.SaliencyProposer``
and the trainable ``tinydet``; YOLOv8 lives in ``models.yolo``."""
