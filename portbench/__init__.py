"""The benchmark of the PyTorch / CUDA port (``blackbox_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``control.py``
reads the comparison's control.  See ``harness.py`` for what a run
does and ``manifest.py`` for the files a cell is made of.
"""
