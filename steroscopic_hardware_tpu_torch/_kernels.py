"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` (``sad.cu``: the SAD kernels; ``sgm.cu``: the SGM
kernels) is compiled at first use by ONE ``nvcc`` call for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
library is named by a hash of all the sources and the flags, so an edited
source is rebuilt and an unchanged set is reused. It lands in
``build_dir()``: ``$STEROSCOPIC_KERNEL_DIR`` if set, else ``build/kernels/``
of the source checkout the package runs from, else (an installed package) a
per-user cache under ``$XDG_CACHE_HOME`` or ``~/.cache``. Nothing here runs
at import time: the CPU tests import every module.

Each launcher checks device, dtype, layout and shape, allocates its outputs
with ``torch.empty``, launches under torch's device guard on the current
CUDA stream of the inputs' device without synchronising, raises if the
launch was refused, and adds one to its count in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import subprocess
import threading
import time
from typing import NamedTuple

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cu"))))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Envelope of the kernels: the packed key cost * 512 + d needs d < 512 and
# cost < 2^21, which (2h + 1) <= 63 guarantees (255 * 63 * 63 < 2^20).
MAX_BLOCK_SIZE = 63
MAX_DISPARITY = 511

# Launches per kernel since the last reset_launches(); the wrappers add one
# where they launch and nowhere else. sgm_aggregate counts both of B3's
# kernels, sgm_aggregate_wide the wide kernel's share (D > 136).
launches = {"sad_wta": 0, "sad_lr": 0, "sgm_aggregate": 0,
            "sgm_aggregate_wide": 0, "sgm_transpose_add": 0,
            "sgm_epilogue": 0}

_lock = threading.Lock()
_lib = None
_ready_devices: set[int] = set()  # devices sad_init has run on


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build_dir() -> str:
    """Directory of the built library (see the module docstring)."""
    env = os.environ.get("STEROSCOPIC_KERNEL_DIR")
    if env:
        return env
    checkout = os.path.dirname(_PKG_DIR)
    if os.path.exists(os.path.join(checkout, "pyproject.toml")):
        return os.path.join(checkout, "build", "kernels")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "steroscopic_hardware_tpu_torch", "kernels")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is "
                           "needed to build csrc/*.cu")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path() -> str:
    """Path of the built library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir(), f"kernels-{digest.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile every ``csrc/*.cu`` in one ``nvcc`` call unless the library
    for these sources exists. Returns (library path, seconds spent
    compiling). The compiler's resource report (registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    path = _library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {', '.join(SOURCES)}:\n"
                           f"{proc.stderr}")
    with open(path[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path, seconds


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.sad_init.argtypes = []
            lib.sad_init.restype = i32
            lib.sad_wta.argtypes = [ptr, ptr, ptr, i64, i64] + [i32] * 8 + [ptr]
            lib.sad_wta.restype = i32
            lib.sad_lr.argtypes = ([ptr] * 7 + [i64, i64] + [i32] * 9
                                   + [ptr])
            lib.sad_lr.restype = i32
            f32 = ctypes.c_float
            lib.sgm_aggregate.argtypes = ([ptr] * 2 + [i32] * 5
                                          + [f32, f32] + [i32] * 6
                                          + [ptr, ptr])
            lib.sgm_aggregate.restype = i32
            lib.sgm_transpose_add.argtypes = [ptr] * 3 + [i32] * 12 + [ptr]
            lib.sgm_transpose_add.restype = i32
            lib.sgm_epilogue.argtypes = [ptr] * 3 + [i32] * 10 + [ptr]
            lib.sgm_epilogue.restype = i32
            lib.sad_error_string.argtypes = [i32]
            lib.sad_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _ready(device: torch.device) -> ctypes.CDLL:
    """The bound library, with ``sad_init`` run once on ``device`` (the
    caller holds torch's device guard for it)."""
    lib = load()
    with _lock:
        if device.index not in _ready_devices:
            _raise_on(lib, lib.sad_init(), "sad_init")
            _ready_devices.add(device.index)
    return lib


def _check_inputs(lefts, rights, block_size, max_disparity):
    """Validate a (F, H, W) uint8 CUDA pair; returns (F, H, W). Rows must be
    dense (stride W, 1); frames may sit at any stride, so the two planes of
    a (B, 2, H, W) upload pass without a copy."""
    for t in (lefts, rights):
        if not t.is_cuda:
            raise ValueError(f"kernel input must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.uint8:
            raise ValueError(f"kernel input must be uint8, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"kernel input must be (F, H, W), got {tuple(t.shape)}")
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            raise ValueError("kernel input rows must be contiguous")
    if lefts.shape != rights.shape or lefts.device != rights.device:
        raise ValueError("left/right must be the same shape on the same device")
    F, H, W = lefts.shape
    if min(F, H, W) < 1:
        raise ValueError(f"empty input {tuple(lefts.shape)}")
    if not 1 <= block_size <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {block_size} outside [1, {MAX_BLOCK_SIZE}]")
    if not 1 <= max_disparity <= MAX_DISPARITY:
        raise ValueError(f"max_disparity {max_disparity} outside [1, {MAX_DISPARITY}]")
    return F, H, W


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.sad_error_string(err).decode()} ({err})")


# The SAD sweep (csrc/sad.cu): a block has DS warps, each sweeping one
# chunk of the d range, and owns TH output rows and 32 KV - 2h output
# columns of one frame (32 KV columns of vertical sums: the outputs and
# their 2h halo). The compiled (KV, tile heights) per kernel, mirroring
# csrc/sad.cu COMPILED, and the warps a block may have.
SAD_COMPILED = {"sad_wta": {8: (8,)}, "sad_lr": {8: (4,)},
                "sad_lr_costs": {8: (2,), 4: (4,)}}
SAD_DS = (1, 2, 4)
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on sm_90
GRID_YZ_MAX = 65535


class SadPlan(NamedTuple):
    kv: int      # vertical-sum columns and output slots per lane (K)
    th: int      # output rows per block
    ds: int      # warps per block, one d chunk each
    strip: int   # output columns per block: 32 kv - 2h
    grid: tuple  # (column strips, row tiles, frames)
    smem: int    # dynamic shared memory bytes


def sad_smem(kernel: str, kv: int, th: int, h: int, max_disparity: int,
             ds: int, W: int) -> int:
    """Shared memory of one block (csrc/sad.cu ``Layout``): the L tile and
    the R tile (maxD columns more), th + 2h rows each, rows congruent to W
    mod 16 apart with room for their 16-byte phase; four prefix rows of
    32 kv + 68 ints per warp; and the dL merge rows unless with costs."""
    def a16(n):
        return (n + 15) & ~15

    def pitch(width):
        return a16(width + 32) + 16 + (W & 15)
    tr = th + 2 * h
    nv = 32 * kv
    total = (a16(tr * pitch(nv)) + a16(tr * pitch(nv + max_disparity))
             + ds * 4 * (nv + 68) * 4)
    return total + (0 if kernel == "sad_lr_costs" else th * nv * 4)


@functools.lru_cache(maxsize=256)
def sad_plan(F: int, H: int, W: int, block_size: int, max_disparity: int,
             with_costs: bool, sms: int, kernel: str = "sad_lr") -> SadPlan:
    """Launch plan of ``sad_wta`` (``kernel="sad_wta"``) or ``sad_lr`` for
    F frames of (H, W) on a card of ``sms`` multiprocessors.

    The fastest plans measured at 1080p (b7 / b16 / b31 at d64 / d128 /
    d256, against KV 4 and other tile heights): 256 vertical-sum columns a
    block (KV 8) and 8 rows for sad_wta, 4 for sad_lr; with costs KV 8
    and 2 rows up to h = 8, above it KV 4 (half the registers a row) and
    4 rows, since a short tile rebuilds the (2h+1)-row window sums the
    more often the larger h is. Warps: one d chunk each; 4 beat 1 and 2
    at one frame and tie with 2 at eight, so 4, or the fewest that give
    256 warps per SM, and never a chunk of fewer than 8 d values; with
    costs one (its neighbour tracking needs the whole sweep). Raises
    ValueError for a shape the kernels do not take."""
    if kernel not in ("sad_wta", "sad_lr"):
        raise ValueError(f"unknown SAD kernel {kernel!r}")
    if kernel == "sad_wta" and with_costs:
        raise ValueError("sad_wta has no costs")
    if min(F, H, W) < 1:
        raise ValueError(f"empty input {(F, H, W)}")
    if not 1 <= block_size <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {block_size} outside [1, {MAX_BLOCK_SIZE}]")
    if not 1 <= max_disparity <= MAX_DISPARITY:
        raise ValueError(f"max_disparity {max_disparity} outside [1, {MAX_DISPARITY}]")
    name = "sad_lr_costs" if with_costs else kernel
    h = block_size // 2
    if name == "sad_lr_costs":
        kv, th = (8, 2) if h <= 8 else (4, 4)
    else:
        kv, th = 8, 8 if name == "sad_wta" else 4
    strip = 32 * kv - 2 * h
    grid = (-(-W // strip), -(-H // th), F)
    if grid[1] > GRID_YZ_MAX or F > GRID_YZ_MAX:
        raise ValueError(f"grid {grid} beyond CUDA's limits")
    ds = 1
    if not with_costs:
        while (ds < SAD_DS[-1] and grid[0] * grid[1] * F * ds < 256 * sms
               and 2 * ds * 8 <= max_disparity + 1):
            ds *= 2
    return SadPlan(kv, th, ds, strip, grid,
                   sad_smem(name, kv, th, h, max_disparity, ds, W))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sad_wta(lefts, rights, block_size: int, max_disparity: int):
    """uint8 (F, H, W) disparity maps, ``d * 255 // max_disparity``."""
    F, H, W = _check_inputs(lefts, rights, block_size, max_disparity)
    plan = sad_plan(F, H, W, block_size, max_disparity, False,
                    _sms(lefts.device), kernel="sad_wta")
    with torch.cuda.device(lefts.device):
        lib = _ready(lefts.device)
        out = torch.empty((F, H, W), dtype=torch.uint8, device=lefts.device)
        stream = torch.cuda.current_stream(lefts.device).cuda_stream
        err = lib.sad_wta(lefts.data_ptr(), rights.data_ptr(),
                          out.data_ptr(), lefts.stride(0), rights.stride(0),
                          F, H, W, block_size, max_disparity, plan.kv,
                          plan.th, plan.ds, stream)
    _raise_on(lib, err, "sad_wta")
    launches["sad_wta"] += 1
    return out


def sad_lr(lefts, rights, block_size: int, max_disparity: int,
           with_costs: bool = False):
    """int32 (F, H, W) maps (dL, dR) and, with costs, (c_left, c_best,
    c_right) of the left map."""
    F, H, W = _check_inputs(lefts, rights, block_size, max_disparity)
    plan = sad_plan(F, H, W, block_size, max_disparity, with_costs,
                    _sms(lefts.device))
    n_out = 5 if with_costs else 2
    with torch.cuda.device(lefts.device):
        lib = _ready(lefts.device)
        outs = [torch.empty((F, H, W), dtype=torch.int32, device=lefts.device)
                for _ in range(n_out)]
        ptrs = [o.data_ptr() for o in outs] + [None] * (5 - n_out)
        stream = torch.cuda.current_stream(lefts.device).cuda_stream
        err = lib.sad_lr(lefts.data_ptr(), rights.data_ptr(), *ptrs,
                         lefts.stride(0), rights.stride(0), F, H, W,
                         block_size, max_disparity, int(with_costs), plan.kv,
                         plan.th, plan.ds, stream)
    _raise_on(lib, err, "sad_lr")
    launches["sad_lr"] += 1
    return tuple(outs)


# -- SGM (csrc/sgm.cu) --------------------------------------------------------

_TYPE_CODES = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}


def _check_volume(t, name, ndim=3):
    """A contiguous uint8 / bfloat16 / float32 CUDA tensor; returns its
    type code."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _TYPE_CODES:
        raise ValueError(f"{name} must be uint8, bfloat16 or float32, "
                         f"got {t.dtype}")
    if t.ndim != ndim or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty {ndim}-D volume, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return _TYPE_CODES[t.dtype]


# B3's two kernels (csrc/sgm.cu). The lane-group kernel: the d values per
# lane compiled there and its largest block; 8 lanes of 17 hold D <= 136.
# Above, the wide kernel: a warp per scan column (both directions), 5, 7
# or 9 d values a lane, 4 or 8 columns a block, the cost staged through a
# ring of WIDE_RINGS slots in shared memory.
AGG_DPTS = (5, 9, 17)
AGG_BLOCK_MAX = 256
AGG_LANES_MAX_D = 8 * AGG_DPTS[-1]
WIDE_DPTS = (5, 7, 9)
WIDE_COLUMNS = (4, 8, 16)
WIDE_RINGS = (3, 4, 5, 6)
WIDE_RING = 4
WIDE_OUT_RING = 3
WIDE_RAW_RING = 3
WIDE_PACE_SLOTS = 8   # the int32 counters the wide kernel paces blocks with
AGG_MAX_D = 32 * WIDE_DPTS[-1]


def wide_smem(dpt: int, columns: int, in_size: int, out_size: int,
              ring: int) -> int:
    """Shared memory of one block of the wide kernel (csrc/sgm.cu
    ``wide_geom``): its mbarriers; ``ring`` slots of both directions' cost
    rows and WIDE_OUT_RING slots of their out rows, a row's 4-byte units
    each in a region of 32 * dpt words and a pad of 32 / units words; and
    WIDE_RAW_RING slots of both directions' raw halves, packed."""
    def half(size):  # one direction's rows
        units = columns * size // 4
        return units * 4 * (32 * dpt + (32 // units if units > 1 else 0))
    bars = 16 * -(-8 * (2 * ring + 2 * WIDE_OUT_RING) // 16)
    raw = 2 * 32 * dpt * columns * out_size
    return (bars + ring * 2 * half(in_size) + WIDE_OUT_RING * 2 * half(out_size)
            + WIDE_RAW_RING * raw)


class AggregatePlan(NamedTuple):
    wide: int    # 1: the wide kernel; 0: the lane-group kernel
    lanes: int   # G: lanes per scan column, a power of two dividing 32
    dpt: int     # d values per lane; lanes * dpt >= D
    block: int   # threads per block (wide: 32 per scan column)
    grid: int    # blocks: exactly enough for K columns
    ring: int    # wide: slots of the cost ring; 0 for the lane-group kernel


def sgm_aggregate_plan(D: int, S: int, K: int, sms: int, in_size: int = 2,
                       out_size: int = 2) -> AggregatePlan:
    """Launch plan of ``sgm_aggregate`` for a (D, S, K) volume of
    ``in_size``-byte costs stored in ``out_size``-byte values (the served
    vertical pass's bfloat16 by default) on a card of ``sms``
    multiprocessors.

    Up to D = 136 the lane-group kernel. A warp spans 32 / lanes scan
    columns, so each of its loads and stores touches rows of 32 / lanes
    elements: more lanes per column multiply the memory transactions,
    fewer cost registers (17 d values per lane is the most that compiles
    without spilling). So 4 lanes up to D = 36, else 8, each holding the
    smallest compiled chunk that covers D. The block is the largest power
    of two (32..256 threads) that still gives 7/8 as many blocks as SMs:
    about one block per SM, each block's columns aligned to whole 32-byte
    sectors of a row. Above D = 136 the lane-group kernel would need 16
    lanes a column; the wide kernel takes the rest: 32 lanes of the
    smallest of 5, 7, 9 d values that covers D, a ring of WIDE_RING slots,
    and the most columns a block (16, 8, 4) whose shared memory fits and
    whose grid still fills half the SMs. An SM's step is paced by its
    memory instructions, whatever their width, and its issue, so wider
    rows move more columns a step (1080p d256 at ring 4, `sgm_probe
    --plans`, PR 16: vertical bf16 -> bf16 4.14 ms with 16 columns, 5.57
    with 8, 9.59 with 4; horizontal u8 -> bf16 6.70 / 7.96 / 10.15), while
    a grid short of the SMs leaves the rest idle. Rings of 3, 5 and 6
    slots were no faster than 4. Raises ValueError for a volume neither
    kernel takes."""
    if D > AGG_MAX_D:
        raise ValueError(f"D = {D} above the kernel's {AGG_MAX_D}")
    if min(D, S, K) < 1:
        raise ValueError(f"empty volume {(D, S, K)}")
    if D > AGG_LANES_MAX_D:
        dpt = min(n for n in WIDE_DPTS if 32 * n >= D)
        for cols in sorted(WIDE_COLUMNS, reverse=True):
            if cols == WIDE_COLUMNS[0] or (
                    -(-K // cols) >= sms // 2
                    and wide_smem(dpt, cols, in_size, out_size,
                                  WIDE_RING) <= SMEM_LIMIT):
                break
        return AggregatePlan(1, 32, dpt, 32 * cols, -(-K // cols), WIDE_RING)
    if D * S * K >= 2 ** 32:
        raise ValueError(f"volume {(D, S, K)} has 2^32 elements or more")
    lanes = 4 if D <= 4 * 9 else 8
    dpt = min(n for n in AGG_DPTS if lanes * n >= D)
    block = 32
    while (block < AGG_BLOCK_MAX
           and -(-K * lanes // (2 * block)) * 8 >= 7 * sms):
        block *= 2
    return AggregatePlan(0, lanes, dpt, block, -(-K // (block // lanes)), 0)


def sgm_aggregate(cost, p1: float, p2: float, out_dtype):
    """(D, S, K) forward + backward SGM aggregation along S, stored in
    ``out_dtype`` (uint8 / bfloat16 / float32)."""
    in_type = _check_volume(cost, "cost")
    if out_dtype not in _TYPE_CODES:
        raise ValueError(f"out_dtype must be uint8, bfloat16 or float32, "
                         f"got {out_dtype}")
    D, S, K = cost.shape
    sms = torch.cuda.get_device_properties(cost.device).multi_processor_count
    plan = sgm_aggregate_plan(D, S, K, sms, cost.element_size(),
                              out_dtype.itemsize)
    with torch.cuda.device(cost.device):
        lib = load()
        out = torch.empty(cost.shape, dtype=out_dtype, device=cost.device)
        # the wide kernel's pacing counters, zeroed on the stream before it
        pace = (torch.zeros(WIDE_PACE_SLOTS, dtype=torch.int32,
                            device=cost.device) if plan.wide else None)
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = lib.sgm_aggregate(cost.data_ptr(), out.data_ptr(), D, S, K,
                                in_type, _TYPE_CODES[out_dtype], float(p1),
                                float(p2), *plan,
                                None if pace is None else pace.data_ptr(),
                                stream)
    _raise_on(lib, err, "sgm_aggregate")
    launches["sgm_aggregate"] += 1
    launches["sgm_aggregate_wide"] += plan.wide
    return out


# B4 (csrc/sgm.cu): a block stages a tile of TRANSPOSE_ROW_BYTES of a x
# TRANSPOSE_ROWS rows b of aT and walks it through a chunk of d planes.
TRANSPOSE_ROW_BYTES = 128
TRANSPOSE_ROWS = 64
TRANSPOSE_WIDTHS = (16, 8, 4, 2, 1)   # bytes per access, widest first
TRANSPOSE_PLANES = 2                  # d planes a block walks
TRANSPOSE_MAX_PLANE = 2 ** 30         # A * B: 32-bit in-plane offsets
TRANSPOSE_IN = (torch.uint8, torch.bfloat16, torch.float32)
TRANSPOSE_OUT = (torch.bfloat16, torch.float32)


class TransposePlan(NamedTuple):
    wa: int      # bytes per load of aT (along a)
    wb: int      # bytes per load of b (along b); 0 without b
    wo: int      # bytes per store of out (along b)
    dpb: int     # d planes per block
    grid: tuple  # (a tiles, b tiles, d chunks)


def pointer_alignment(ptr: int) -> int:
    """The largest power of two up to 16 that divides ``ptr``."""
    return min(16, ptr & -ptr) if ptr else 16


def _access_width(what, itemsize, cap, pitch, align):
    for w in TRANSPOSE_WIDTHS:
        if itemsize <= w <= cap and pitch % w == 0 and align % w == 0:
            return w
    raise ValueError(f"{what}: no access width for a pitch of {pitch} bytes "
                     f"at alignment {align}")


@functools.lru_cache(maxsize=256)
def transpose_add_plan(D: int, B: int, A: int, in_dtype, out_dtype,
                       has_b: bool, sms: int, align_a: int = 16,
                       align_b: int = 16, align_out: int = 16
                       ) -> TransposePlan:
    """Launch plan of ``sgm_transpose_add`` for aT (D, B, A) of
    ``in_dtype`` (and b (D, A, B) of it when ``has_b``) into out (D, A, B)
    of ``out_dtype``, with base pointers aligned to ``align_*`` bytes, on a
    card of ``sms`` multiprocessors.

    Each access width is the widest of 16, 8, 4, 2, 1 bytes, no narrower
    than an element, that divides the row pitch (A elements for aT, B for
    b and out) and the base pointer; b's covers at most 8 elements (a
    thread's run of b). The tile is 128 bytes of a by 64 rows b. A block
    walks TRANSPOSE_PLANES d planes, its second plane's copies in flight
    while it writes the first; one plane fewer when the grid would give
    fewer than 4 blocks per SM. At 1080p d64-d256 (24-48 registers, 8
    blocks per SM) 1 or 2 planes were fastest and 8 to D planes 6-40%
    slower: the resident blocks, not a deep pipeline, keep the bytes in
    flight. Raises ValueError for a volume the kernel does not take."""
    if in_dtype not in TRANSPOSE_IN:
        raise ValueError(f"aT must be uint8, bfloat16 or float32, got "
                         f"{in_dtype}")
    if out_dtype not in TRANSPOSE_OUT:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    if min(D, B, A) < 1:
        raise ValueError(f"empty volume {(D, B, A)}")
    if A * B > TRANSPOSE_MAX_PLANE:
        raise ValueError(f"plane {A} x {B} above {TRANSPOSE_MAX_PLANE} "
                         f"elements")
    sa, so = in_dtype.itemsize, out_dtype.itemsize
    wa = _access_width("aT", sa, 16, A * sa, align_a)
    wb = (_access_width("b", sa, min(16, 8 * sa), B * sa, align_b)
          if has_b else 0)
    wo = _access_width("out", so, 16, B * so, align_out)
    gx = -(-A // (TRANSPOSE_ROW_BYTES // sa))
    gy = -(-B // TRANSPOSE_ROWS)
    dpb = min(D, TRANSPOSE_PLANES)
    while dpb > 1 and gx * gy * -(-D // dpb) < 4 * sms:
        dpb //= 2
    gz = -(-D // dpb)
    if max(gy, gz) > GRID_YZ_MAX:
        raise ValueError(f"grid {(gx, gy, gz)} beyond CUDA's limits")
    return TransposePlan(wa, wb, wo, dpb, (gx, gy, gz))


def sgm_transpose_add(aT, b, out_dtype):
    """(D, A, B) ``aT.transpose(1, 2) [+ b]`` in float32, stored in
    ``out_dtype`` (bfloat16 / float32); aT (D, B, A), b None or (D, A, B)
    of aT's dtype on its device."""
    in_type = _check_volume(aT, "aT")
    D, B, A = aT.shape
    if b is not None:
        _check_volume(b, "b")
        if (b.shape != (D, A, B) or b.dtype != aT.dtype
                or b.device != aT.device):
            raise ValueError(f"b must be {(D, A, B)} {aT.dtype} on "
                             f"{aT.device}, got {tuple(b.shape)} {b.dtype} "
                             f"on {b.device}")
    if out_dtype not in TRANSPOSE_OUT:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    with torch.cuda.device(aT.device):
        lib = load()
        out = torch.empty((D, A, B), dtype=out_dtype, device=aT.device)
        plan = transpose_add_plan(
            D, B, A, aT.dtype, out_dtype, b is not None, _sms(aT.device),
            pointer_alignment(aT.data_ptr()),
            16 if b is None else pointer_alignment(b.data_ptr()),
            pointer_alignment(out.data_ptr()))
        stream = torch.cuda.current_stream(aT.device).cuda_stream
        err = lib.sgm_transpose_add(aT.data_ptr(),
                                    None if b is None else b.data_ptr(),
                                    out.data_ptr(), D, B, A, in_type,
                                    _TYPE_CODES[out_dtype], *plan[:4],
                                    *plan.grid, stream)
    _raise_on(lib, err, "sgm_transpose_add")
    launches["sgm_transpose_add"] += 1
    return out


# B5 (csrc/sgm.cu): a block owns EPILOGUE_TILE x EPILOGUE_TILE pixels and
# walks all D planes, both volumes' tiles of a plane staged into one slot of
# a ring. The ring depths the library compiled, and the one each type takes.
EPILOGUE_TILE = 64
EPILOGUE_RINGS = (2, 3, 4)
EPILOGUE_RING = {torch.uint8: 4, torch.bfloat16: 3, torch.float32: 3}
EPILOGUE_MAX_PLANE = 2 ** 30          # H * W: 32-bit in-plane offsets


class EpiloguePlan(NamedTuple):
    wv: int      # bytes per load of agg_v (along x)
    wh: int      # bytes per load of agg_ht (along y)
    stages: int  # ring slots: planes in flight + 1
    grid: tuple  # (x tiles, y tiles)


@functools.lru_cache(maxsize=256)
def sgm_epilogue_plan(D: int, H: int, W: int, dtype, align_v: int = 16,
                      align_ht: int = 16) -> EpiloguePlan:
    """Launch plan of ``sgm_epilogue`` for agg_v (D, H, W) and agg_ht
    (D, W, H) of ``dtype`` with base pointers aligned to ``align_*`` bytes.

    Each access width is the widest of 16, 8, 4, 2, 1 bytes, no narrower
    than an element, that divides the row pitch (W elements for agg_v, H
    for agg_ht) and the base pointer: at 1080p uint8 16 bytes on agg_v's
    1920-byte rows, 8 on agg_ht's 1080-byte rows. The grid has one block
    per 64 x 64 pixel tile (two blocks an SM: the registers of the pixels'
    running state allow no more). The ring takes 4 slots for uint8 (8 KB
    each) and 3 for bfloat16 and float32 (16 and 32 KB), from the depths
    timed at 1080p and on a 240-column W-band (``sgm_probe --epilogue
    --plans``). Raises ValueError for a volume the kernel does not
    take."""
    if dtype not in EPILOGUE_RING:
        raise ValueError(f"aggregates must be uint8, bfloat16 or float32, "
                         f"got {dtype}")
    if min(D, H, W) < 1:
        raise ValueError(f"empty volume {(D, H, W)}")
    if H * W > EPILOGUE_MAX_PLANE:
        raise ValueError(f"plane {H} x {W} above {EPILOGUE_MAX_PLANE} "
                         f"elements")
    s = dtype.itemsize
    wv = _access_width("agg_v", s, 16, W * s, align_v)
    wh = _access_width("agg_ht", s, 16, H * s, align_ht)
    grid = (-(-W // EPILOGUE_TILE), -(-H // EPILOGUE_TILE))
    if grid[1] > GRID_YZ_MAX:
        raise ValueError(f"grid {grid} beyond CUDA's limits")
    return EpiloguePlan(wv, wh, EPILOGUE_RING[dtype], grid)


def sgm_epilogue(agg_v, agg_ht, subpixel: bool):
    """float32 (H, W) disparity: first-min argmin over d of agg_v (D, H, W)
    + agg_ht (D, W, H) transposed, with the parabola when ``subpixel``."""
    in_type = _check_volume(agg_v, "agg_v")
    _check_volume(agg_ht, "agg_ht")
    D, H, W = agg_v.shape
    if (agg_ht.shape != (D, W, H) or agg_ht.dtype != agg_v.dtype
            or agg_ht.device != agg_v.device):
        raise ValueError(f"agg_ht must be {(D, W, H)} {agg_v.dtype} on "
                         f"{agg_v.device}, got {tuple(agg_ht.shape)} "
                         f"{agg_ht.dtype} on {agg_ht.device}")
    with torch.cuda.device(agg_v.device):
        lib = load()
        plan = sgm_epilogue_plan(D, H, W, agg_v.dtype,
                                 pointer_alignment(agg_v.data_ptr()),
                                 pointer_alignment(agg_ht.data_ptr()))
        out = torch.empty((H, W), dtype=torch.float32, device=agg_v.device)
        stream = torch.cuda.current_stream(agg_v.device).cuda_stream
        err = lib.sgm_epilogue(agg_v.data_ptr(), agg_ht.data_ptr(),
                               out.data_ptr(), D, H, W, in_type,
                               int(subpixel), *plan[:3], *plan.grid, stream)
    _raise_on(lib, err, "sgm_epilogue")
    launches["sgm_epilogue"] += 1
    return out
