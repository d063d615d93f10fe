"""repro_torch: the PyTorch/CUDA port of the ``repro`` FCDRAM framework.

It mirrors ``repro``'s layout (``core/``, ``kernels/``, ``models/``,
``pud/``, ``analysis/``), imports ``torch`` and ``numpy`` only, and runs on the card
unless a caller passes ``device="cpu"``.  ``repro`` stays the reference the port is tested against.
"""
