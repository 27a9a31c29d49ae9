"""YOLOv8 in PyTorch — the reference's pretrained auto-label model family
(11_dataset_labeling.py:10, 96-99): graph (model), official-checkpoint
loading (convert), release-asset download (download), and the
labeling-slot detector callable (detector)."""
