"""roombench: the benchmark of the PyTorch and CUDA port, ``yjs_tpu_torch``,
as a Yjs room server on one card.  ``run.py`` runs one cell once."""
