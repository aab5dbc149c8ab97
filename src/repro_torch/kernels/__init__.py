"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper keeps a count of its kernel launches (``ops.launches``);
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets
them to 0.
"""

from typing import Dict

from .flash_attention import ops as _flash_ops
from .paged_attention import ops as _paged_ops
from .rmsnorm import ops as _rmsnorm_ops
from .ssd_scan import ops as _ssd_ops

__all__ = ["launch_counts", "reset_launch_counts"]

_OPS = {"flash_attention": _flash_ops, "paged_attention": _paged_ops,
        "rmsnorm": _rmsnorm_ops, "ssd_chunk": _ssd_ops}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _OPS.items()}


def reset_launch_counts() -> None:
    for mod in _OPS.values():
        mod.launches = 0
