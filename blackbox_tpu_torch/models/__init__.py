"""Learned models: trail segmentation (ASTA equivalent) and real/bogus
classification (MeerCRAB equivalent)."""
