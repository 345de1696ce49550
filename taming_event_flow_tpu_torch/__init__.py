"""PyTorch/CUDA port of ``taming_event_flow_tpu``.

The JAX package beside this one is the reference; this package imports
nothing of it, nor JAX. Layout mirrors it: ``ops/ models/ metrics/
training/ pipeline/ utils/``, plus ``csrc/`` for the hand-written CUDA
kernels. Entry points run on the card (``device="cuda"``) and raise when no
card is found; they run on the CPU only when the caller passes
``device="cpu"``.
"""
