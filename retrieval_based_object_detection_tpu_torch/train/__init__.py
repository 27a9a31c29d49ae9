"""Training: fine-tune the CLIP tower and a classification head on
product crops."""
