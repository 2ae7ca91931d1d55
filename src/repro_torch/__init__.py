"""PyTorch/CUDA port of the ``repro`` serving stack, for one NVIDIA H100.

Module paths mirror ``repro`` so each counterpart is found by name.
The port imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``; the JAX package stays the reference its tests hold it
against.  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``.  Every Pallas kernel on a ported path
becomes a hand-written Hopper kernel under ``kernels/csrc/``.
"""
