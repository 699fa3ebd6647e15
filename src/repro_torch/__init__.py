"""PyTorch/CUDA port of the hybrid node×core SpMV/CG system.

Beside the JAX package ``repro`` (the reference), this package builds the
same SpMV plans and runs the distributed SpMV and the Krylov solvers on
one NVIDIA card, the ``(node, core)`` grid held as leading tensor axes.
The local matvec runs through hand-written CUDA kernels
(``repro_torch.kernels``).  Entry points place tensors on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
