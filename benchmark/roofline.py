"""The card's peaks and the least time a kernel could take.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
device memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s;
int32 132 SMs x 64 lanes x 1.98 GHz. A bound counts each input byte read
once and each output byte written once, and the operations the algorithm
needs; it is the larger of bytes over the memory rate and operations over
the peak of their type.

The served SGM chain aggregates twice a frame (B3: the vertical paths on
the (D, H, W) cost volume, the horizontal ones on its (D, W, H) transpose),
with ``sgm_aggregate_lanes_kernel`` up to D 136 and
``sgm_aggregate_wide_kernel`` above. Each launch reads the D x H x W costs
in its input type and writes the forward + backward sum in its output
type, both named by the kernel's template arguments.
"""

from __future__ import annotations

import re

MEM_BPS = 3.35e12
F32_OPS = 67e12
I32_OPS = 132 * 64 * 1.98e9

AGGREGATE_KERNELS = ("sgm_aggregate_lanes_kernel",
                     "sgm_aggregate_wide_kernel")
AGGREGATE_PASSES_PER_FRAME = 2
# per cost element and direction: min, min, add, min, add, min, add, sub
AGGREGATE_OPS_PER_ELEMENT = 2 * 8

_DEMANGLED = {"unsigned char": 1, "__nv_bfloat16": 2, "float": 4}
_MANGLED = (("h", 1), ("13__nv_bfloat16", 2), ("f", 4))


def bound_s(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two."""
    t_bytes, t_ops = nbytes / MEM_BPS, ops / op_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def aggregate_kernel(name: str) -> str | None:
    """Which of B3's kernels a device event name is, or None."""
    for kernel in AGGREGATE_KERNELS:
        if kernel in name:
            return kernel
    return None


def _io_sizes(name: str, kernel: str) -> tuple[int, int] | None:
    """Element sizes of the input and output types in a kernel name,
    demangled (``kernel<unsigned char, __nv_bfloat16, 5>``) or mangled
    (``...kernelIh13__nv_bfloat16Li5EE...``)."""
    rest = name[name.index(kernel) + len(kernel):]
    if rest.startswith("<"):
        args = [a.strip() for a in rest[1:].split(",")]
        if len(args) >= 2 and args[0] in _DEMANGLED and \
                args[1] in _DEMANGLED:
            return _DEMANGLED[args[0]], _DEMANGLED[args[1]]
        return None
    if rest.startswith("I"):
        sizes, rest = [], rest[1:]
        for _ in range(2):
            if sizes and rest.startswith("S") and "_" in rest[:4]:
                # a substitution: the second type repeats the first
                sizes.append(sizes[0])
                rest = rest[rest.index("_") + 1:]
                continue
            for code, size in _MANGLED:
                if rest.startswith(code):
                    sizes.append(size)
                    rest = rest[len(code):]
                    break
            else:
                return None
        return sizes[0], sizes[1]
    return None


def aggregate_pass(name: str, planes: int, height: int,
                   width: int) -> tuple[float, float] | None:
    """(bytes, operations) of one B3 launch named ``name`` over a
    ``planes`` x ``height`` x ``width`` cost volume, or None where the
    name is not B3's or its types cannot be read."""
    kernel = aggregate_kernel(name)
    if kernel is None:
        return None
    sizes = _io_sizes(re.sub(r"^void ", "", name), kernel)
    if sizes is None:
        return None
    volume = planes * height * width
    return (volume * (sizes[0] + sizes[1]),
            volume * AGGREGATE_OPS_PER_ELEMENT)
