"""Reporting layer: obslog, quicklooks, thumbnails, finding charts."""
