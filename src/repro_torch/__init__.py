"""repro_torch — the PyTorch/CUDA port of the table-based function
approximation system, beside the JAX package ``repro``.

The port imports ``torch`` and numpy and nothing of JAX or of ``repro``: it
keeps its own copies of the design flow (``core``) and of the host-side
observability layer (``obs``).  Each TPU kernel of the JAX package becomes a
hand-written Hopper kernel (``csrc/``, bound in ``kernels/``) beside its plain
PyTorch version; entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
