"""PyTorch/CUDA port of the ``repro`` data plane, for one NVIDIA H100.

The JAX package ``repro`` stays the reference. This package mirrors its
layout (``models``, ``configs``, ``kernels``, ``serve``, ``launch``) so
that each module's counterpart is found under the same name, and keeps
its own copies of everything it needs: it imports ``torch`` and
``numpy`` and never ``jax`` or ``repro``.

Entry points take an explicit ``device``. ``None`` means the GPU and
raises when there is none; the CPU is used only when asked for with
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""

from .device import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
