"""GTIR → CUDA C++ for the five hand-written Hopper kernel skeletons.

Counterpart of gt4py_tpu/cartesian/backend/pallas_codegen.py
(``_BlockEvaluator``, which renders GTIR into the Pallas kernels) plus the
expression renderer of gt4py_tpu/cartesian/backend/c_codegen.py, copied
here with a ``__device__`` prelude. As on the TPU, the kernels are generated
per stencil: the hand-written part is a kernel skeleton, and the stencil's
statements are rendered into its body as CUDA C++.

Five skeletons. :func:`generate` takes the first that serves the
stencil, from its GTIR and the stage-fusion switch alone, in this order
(the dispatch of ``pallas_codegen.build_pallas_fn``, :400-512, with
``pallas_seq.build_staged_fn``'s fusion switch, :302-333, where
``column`` is taken):

``plane`` — replaces K1, ``pallas_split.build_plane_split_fn``
(gt4py_tpu/cartesian/backend/pallas_split.py:195, ``pallas_call`` at
:424). It serves stencils whose vertical loops are all PARALLEL with no
K-offset reads, whose fields are all 3-D without data dimensions, and whose
temporaries stay inside one loop.
    Mapping: one launch per vertical loop; grid (J tiles, I tiles, K walks
    of ``PL_TK`` levels), one block per PL_TI × PL_TJ tile, which walks the
    levels of its K walk (PARALLEL levels are independent, so any order is
    right) and pays its setup once a walk. K1 splits each field into a
    128-lane main block and a J-halo strip only because of the TPU's
    128-lane padding (pallas_split.py:1-29); here J is simply the contiguous
    axis (storage/layout.py). Each statement runs over the tile widened by
    its extent (``analyzed.stmt_extents``), so the halo is recomputed at
    tile edges. Each field's address at the tile's corner is computed once
    a block in 64 bits, at each level once a level, and offsets from it are
    32-bit integers (the wrapper refuses a field whose strides would carry
    them beyond; ``KernelModule.offset_span``). Temporaries live in shared
    memory, one plane each, zero-filled only at the levels of a section
    whose first access to it is not an unconditional write of the whole
    plane (hdiff: none). Statements run in program order with a barrier
    only where :meth:`_Generator._hazard` finds a plane shared, and one that
    turns each level over. API fields are written only at domain points of
    the block's own tile. Two variants. ``gt_plane_<n>``, for arguments
    that may overlap, is a row of threads along J as wide as the widest
    statement's columns; each thread takes one column of a statement and
    walks its rows of I, one point at a time, loading the fields directly.
    ``gt_plane_<n>_r``, launched when no two field buffers overlap,
    computes register patches (:meth:`_Generator._emit_patch_variant`):
    a thread evaluates a statement over a patch of ``PL_PATCH_WIDTH`` (2)
    consecutive J points, a vector of each field (8 bytes of float32, 16
    of float64, 4 of a half type), by ``PL_PATCH_ROWS`` (2) rows of I, at
    most 16 bytes of the loop's widest field (float64: one row); wider
    patches, a whole 16-byte vector of float32 or float16 a row, measured
    slower (their registers and the threads they leave idle). It loads each
    element the statement's reads touch once into registers (a row's whole
    vectors as vectors, the centre row's neighbours one by one), evaluates
    the statement's expression at each point, in the plain version's
    order of operations, and stores whole vectors. Its tiles start on the
    storage's vectors, not on the domain's columns: the domain's first
    column may lie inside a vector (the benchmark's halo of 2 puts it 8
    bytes past one), so the launcher shifts the tiles along J by the field's
    shift (``PatchLayout.word``: the element's address, over its size,
    modulo the vector), and the tiles at the domain's two edges overhang
    it, their points beyond it masked. A field whose J stride is not its
    item size, whose row or level pitch is not whole vectors, or whose
    vectors start elsewhere moves element by element in the patches (the
    wrapper decides from the buffers it observes and says so in the word,
    which ``PatchLayout.patched`` reads); a half
    field so sends the launch to ``gt_plane_<n>``, which reads it faster
    (on 259×259 storages, an odd row pitch: float16 50 µs a step there
    against 64.5 in the patches; float32 82 against 37, float64 101
    against 60, so those stay in the patches). Each
    statement runs over its extent rounded out to whole patches; the
    temporaries' planes span what the patches read, a temporary only one
    unmasked statement writes is stored as whole vectors (its points beyond
    the extent are points no read finds), any other store goes point by
    point. The 3-D fields the loop reads are prefetched through a
    ``cp.async`` ring of planes over their reads' footprints rounded out to
    whole vectors (the tile ring below, at most ``PL_RING_LEVELS`` deep):
    one ``cp.async`` a vector, element copies for a field off the vectors
    or a vector cut by the valid points' edge (a half element by a load and
    a store: ``cp.async`` has no 2-byte copy), which elements a thread
    copies worked out once a block.
    A tile inside the domain (``gt_inner``) takes no guard on its stores
    and direct loads. Bound on the H100: bytes. hdiff reads two fields and
    writes one, three 21 MB float32 streams at 256×256×80 — more than the
    50 MB L2 — so a step moves ≈ 63 MB through device memory, 18.8 µs at
    3.35 TB/s. The first version, one K plane a block, 64-bit index
    arithmetic at every point and every temporary zero-filled behind a
    barrier, took 51.4 µs, and the one point a thread after it 44 µs, its
    time following the instructions of a level (4,400 warp instructions a
    block-level), not the bytes (float16, with half the bytes, took as
    long). The patches cut the SASS instructions a point in a level's loops
    2.1-2.4× (127.5 → 54-60 in float32) and a step by a third or more:
    float32 44.3-44.9 → 29.6-29.7 µs, float16 48.3-49.3 → 28.6-29.1,
    bfloat16 50.4-51.0 → 28.7-29.4; float64, whose twice the bytes its
    ring moves hold it, stays at 57.5-57.9 (57.6-58.5 before), and on an
    odd row pitch is 4.5-7 % slower than before (59.8-60.6 against
    56.2-57.5). What holds float32 now is latency more
    than the instruction rate: with the copies taken out, the statements take 24.7 µs a
    step; with the statements taken out, the copies 31.5 at two blocks an
    SM, so ``PL_PATCH_BLOCKS`` keeps four (PERF.md §6; NVIDIA H100
    80GB HBM3, 700 W).

``fused_plane`` — replaces K2, ``pallas_codegen.build_plane_fn``
(pallas_codegen.py:1829, kernel :1887, ``pallas_call`` :1992). It serves
the rest of K2's class: all-PARALLEL stencils without K-offset reads whose
temporaries cross loops, whose API fields are read at a horizontal offset
after they are written, or which read lower-dimensional fields (IJ, K),
data dimensions or GlobalTables; ``while`` and horizontal regions too.
    Mapping: ONE launch per stencil; grid (J tiles, I tiles, K blocks of
    ``FP_TK`` levels), 256 threads per TI × TJ tile. A block first stages
    what does not vary along K into shared memory, once: every GlobalTable
    and the tile of each read-only IJ field with its halo. It then walks
    the levels of its K block; at each level it evaluates every statement
    of every vertical loop in program order, each over its tile widened by
    its extent. Temporaries and the API fields read at a horizontal offset
    after they are written live in shared-memory planes over their
    footprint (the union of the points the statements write and read), so
    the halo a loop hands to the next is recomputed by the block and never
    leaves the SM. API fields are stored to device memory only at the
    points the block owns: its tile, and for the tiles at the domain's edge
    the halo beyond it that a statement's extent reaches (the plain version
    writes there too). The TPU's one-hot table lookup
    (pallas_codegen.py:62-69) was a Mosaic workaround; here a table read is
    an indexed shared-memory load. The layout is dynamic shared memory,
    with ``cudaFuncSetAttribute`` above 48 KB and :class:`CudaUnsupported`,
    naming the bytes, above the H100's 227 KB.
    Two variants, as ``column``'s: ``gt_fused_plane_0_r``, launched when
    no two field buffers overlap, prefetches its inputs through a ring of
    planes (below), and the plain one loads them directly. The ring, the
    tile counterpart of K2's pipelined input blocks: each 3-D API field the
    walk reads (and, of one it writes, a read of the level before the
    level's first write) is a ring of up to ``TILE_RING_LEVELS`` planes
    over the footprint of its reads, fewer where the block would otherwise
    leave under ``TILE_RESIDENT_THREADS`` threads resident on an SM, which
    the whole block fills with ``cp.async``, each level depth − 1 levels
    before the walk reaches it, at most ``RING_BYTES_MAX`` a block; one ``cp.async.wait_group``
    and the level's first barrier make a level's planes visible. Between statements a barrier stands only where
    the later one reads, at another thread's point, what the earlier one
    wrote, or overwrites what it read (:meth:`_Generator._hazard`, from the
    GTIR): hdiff_sponge pays three barriers a level (the level's, lap |
    flx, fly | out_field) where it paid four and a fill barrier.
    Bound on the H100: bytes, as for ``plane``; the staged IJ fields and
    tables are read once per block instead of once per level. Measured
    (PERF.md; NVIDIA H100 80GB HBM3, 700 W): hdiff_sponge 65.0 µs a
    step in float32 (a ring of 4 levels) and 71.5 in float64 (2 levels) at
    256×256×80, against 76.6 and 84.7 for the plain-pointer variant, which
    has the same barriers and no ring, and a bound of 12.6 and 25.2.
    Longer walks (``FP_TK`` 8, 16, 80) lost: each level's work on the SM,
    not memory, holds it.

``column`` — replaces K3, ``pallas_seq._build_stage_call``
(gt4py_tpu/cartesian/backend/pallas_seq.py:732, ``pallas_call`` at :1130,
driven by ``build_staged_fn`` :243). It serves the sequential and
K-offset stencils whose loops read no value written in the same loop at a
horizontal offset: FORWARD/BACKWARD loops (vadv, tridiag), PARALLEL loops
beside them, ``while``, variable and absolute K.
    Mapping: one launch per vertical loop, in order, on the current stream.
    One thread per (i, j) column of the loop's statement extents walks the
    loop's sections in order, K ascending (FORWARD) or descending
    (BACKWARD); a PARALLEL loop runs statement by statement over its K
    range. Each thread owns its column, so a read of an already-updated
    value (``sup[0, 0, -1]``) reads back what the same thread wrote: no
    carry planes or rings as in K3. Reads at K offsets are clamped to the
    allocation (``gt_clampk``), the semantics of K3's clamped shifted
    streams. A temporary that one FORWARD or BACKWARD walk writes and reads
    only at its own column, at K offsets behind the walk and outside any
    ``while``, is a register with a ring of carries, as in ``fused_column``
    (below); a later loop that reads it reads a (K, I, J) buffer the walk
    stores it to, zero-filled only where that loop could read a level the
    walk does not set in full (vadv: 9 of its 11 temporaries are registers
    only, ``ccol`` and ``dcol`` keep an unfilled buffer, which the on-chip
    pair below replaces with shared memory). Every other temporary is a
    (K, I, J) buffer the wrapper allocates zero-filled.
    The ``__restrict__`` variant (below) lets the compiler forward stored
    values instead of reloading them, and prefetches each walk's levels:
    K3 streams every (field, K offset) as its own plane and Pallas fetches
    the next grid step's planes while the current one computes; here each
    (field, horizontal offset) the walk reads is a stream that the thread
    copies with ``cp.async``, ``RING_LEVELS - 1`` levels ahead of its chain,
    into its own slots of a ring of levels in dynamic shared memory, laid
    out [slot][stream][thread]; the walk's K-offset reads of a stream read
    neighbouring slots. The thread copies only what it reads itself, so no
    barrier is needed. A field the walk writes is streamed only where it is
    read at the walk's level before that level's first write (tridiag's
    ``sup`` and ``rhs``). The ring takes at most ``RING_BYTES_MAX`` a
    block, so that two blocks share an SM: a walk with more streams rings
    those it reads first and loads the rest directly. The plain-pointer
    variant loads directly, since a prefetched value could predate a write
    through another name.
    Bound on the H100: the compulsory bytes (vadv: five fields read, one
    written, 125.3 MB a step in float32 over its 255×256×80 domain, 37.4 µs
    at 3.35 TB/s) and the dependent K chain, 80 levels a walk per thread.
    Without the ring each level waited for its own loads (by estimate about
    8 KB in flight per SM, half what hides the memory latency); with it the
    copies of the next levels are in flight while a level computes, and the
    two walks reach 2.7-2.9 TB/s, about the card's copy rate. What was left
    was bytes: the FORWARD walk stored ``ccol`` and ``dcol`` to device
    memory and the BACKWARD one read them back with ``u_pos`` again, 231 MB
    a step in all.
    So a FORWARD loop and the BACKWARD loop after it run in ONE launch where
    every value the second reads from the first is a temporary the first
    keeps in a register, read at the thread's own column (vadv's ``ccol``
    and ``dcol``; :meth:`_Generator._plan_on_chip`): ``gt_column_<n>_<n +
    1>_r``, a third kernel beside the two, in the ``__restrict__`` path only.
    One thread walks its column FORWARD, then BACKWARD, with the registers,
    carries and rings of the two kernels; a cross value goes to the
    thread's element of a slab of dynamic shared memory, [k][value][thread],
    where the BACKWARD walk reads it back. The slab takes nk levels of every
    column of the block, so it holds fewer columns on an SM than the two
    kernels keep resident: blocks of 64 columns and deeper rings
    (``ON_CHIP_ROWS``, ``ON_CHIP_RING_LEVELS``). The launcher of the FORWARD
    loop takes the pair from the shape (``OnChip.serves``: no overlap, and
    nk small enough that the resident columns times the streams' item size
    reach ``ON_CHIP_RESIDENT_BYTES``), and the BACKWARD loop's launcher then
    launches nothing; taller domains, and tridiag, whose cross values are
    API fields that must reach device memory anyway, keep the two launches.
    vadv then moves the compulsory bytes plus ``u_pos`` read again (from
    L2 where it is still there; keeping it in the slab instead left fewer
    columns resident and lost), bounded by how many columns the slab leaves
    resident: float32 at 256×256×80 went from 84 to 66 µs a step, float64
    from 152 to 118 (PERF.md; NVIDIA H100 80GB HBM3, 700 W).

``fused_column`` — replaces K4, ``pallas_seq._build_fused_call``
(pallas_seq.py:1490, ``pallas_call`` at :1704). Only with the stage-fusion
switch on (``config.fuse_stages``, off by default as in the JAX package),
and only for K4's class among the stencils ``column`` serves: two or more
vertical loops over 3-D fields without data dimensions, no name written in
two loops, every loop's sections covering the K range back to back, no
carry read that reaches before its walk's first level, no ``while`` and no
variable or absolute K. It also declines what needs another column's
value: a read at a horizontal offset of anything the stencil writes (K4
serves that from its whole-plane scratch; here ``column`` does, loop by
loop).
    Mapping: ONE launch per stencil. K4's grid walks the loops' K ranges
    back to back on one core; Hopper blocks run in no order, so here a
    thread owns its column and runs the loops back to back itself: one
    thread per (i, j) column of the union of all statement extents, every
    statement guarded by its own extent. FORWARD walks ascend, BACKWARD
    ones descend, a PARALLEL loop runs level by level (it reads nothing it
    writes at a K offset, so that equals statement by statement).
    Temporaries never touch device memory: a temporary used in one loop is
    a register, and its carries (``datacol[0, 0, 1]``) a ring of registers
    rotated once a level, ``max |dk|`` deep; a level at which its section
    does not write it first, unconditionally and over the whole column set,
    starts it at 0, the plain version's zero-filled temporary. A value that
    a later loop reads (vadv's ``ccol`` and ``dcol``, K4's cross names,
    ``_cross_names`` :1451) is also stored level by level where that loop
    reads it back, by the same thread. K4 keeps it in full-K VMEM scratch;
    the H100's shared memory cannot hold it for every column at once
    (vadv: 2 × 80 × 4 B a column, 42 MB for 65,536 columns, against
    132 × 227 KB), so it goes to a (K, I, J) buffer in device memory, which
    the L2 mostly holds between the two walks, zero-filled only where a
    later loop could read a level the loop does not set in full (vadv:
    neither). An API field a later loop reads (tridiag's ``sup`` and
    ``rhs``) is read back from device memory, where the same thread stored
    it. Each thread reads only its own column, so no barrier is needed. A
    slab of dynamic shared memory per block was measured and lost 3 of 4
    cells, by up to 2×, to its occupancy (PERF.md). Blocks of
    ``FC_THREADS`` columns, 32 along J. Reads at K offsets clamp
    (``gt_clampk``) as in ``column``; ``--fmad=false``; a ``__restrict__``
    variant under the same no-overlap check, in which every walk prefetches
    its levels through the ring ``column`` has (one region of dynamic
    shared memory, reused walk after walk with no barrier between them:
    where the walks mix 4- and 8-byte streams, every stream takes 8 bytes a
    thread, so a thread's elements lie at the same bytes in every walk); a
    later walk also streams what an earlier one stored (vadv's ``ccol`` and
    ``dcol``, tridiag's ``sup`` and ``rhs``), behind a ``__threadfence()``
    that orders the thread's stores before its asynchronous copies;
    ``NOTHING_LAUNCHED`` on an empty grid.
    Bound on the H100: the compulsory bytes (vadv: five fields read, one
    written, 6 × 21.0 MB float32 at 256×256×80, ≈ 38 µs at 3.35 TB/s) and
    the dependent K chain, 2 × 80 levels of division and reads per thread.
    What the design does about them: the loop-local temporaries (9 of
    vadv's 11) never touch device memory, no buffer is zero-filled, the
    carries stay in registers, the ring keeps the next levels' copies in
    flight while a level computes, and at 256×256 every block is resident
    at once (256 blocks, two per SM, each with at most 61,440 bytes of ring
    for vadv float64). Times against the bound are in PERF.md (NVIDIA H100
    80GB HBM3, 700 W).

``tiled`` — replaces K5, ``pallas_codegen._build_tiled_fn``
(pallas_codegen.py:637, kernel :682, ``pallas_call`` :818). It serves
what ``column`` declines: a value written in a vertical loop and read at a
horizontal offset in the same loop, as in a sweep that couples
neighbouring columns at every level.
    Mapping: one launch per vertical loop; grid (J tiles, I tiles), 512
    threads per TL_TI × TL_TJ tile. The block walks the loop's K range in its
    order (PARALLEL ascending). At each level it evaluates each statement
    over its tile widened by its extent, with barriers placed as in
    ``fused_plane``: one that turns the level over, and one between two
    statements only where a plane is shared (smoothed_column_sum: one
    between ``acc`` and ``out``, where it paid two a level). The values the
    loop writes and reads at a horizontal offset live in a small ring of
    shared-memory planes, one per level the loop reads back at other
    points; a read of a level the ring does not hold — one the walk has not
    written — is a global load. A thread computes the same points at every
    level, so a value read at the thread's own point a level or more behind
    the walk (``acc[0, 0, -1]``, ``out[0, 0, -1]``), written whole by one
    statement of one extent at every level read, is a register carry, as in
    ``column`` (:meth:`_Generator._plan_carries`). Every value is also
    stored to device memory at the points the block owns, so later loops
    and reads at variable or absolute K (plain global loads, clamped as the
    ``column`` kernel clamps them) see it; a temporary that nothing reads
    from device memory has no buffer and is never stored (smoothed_column_
    sum's ``acc``). Other temporaries have global (K, I, J) buffers as in
    ``column``. Two variants as in ``fused_plane``: the ``_r`` one has the
    input ring and carries API fields too; the other carries temporaries
    only, since another name may share an API field's memory.
    A read of an earlier level beyond the points its writers compute there
    (``acc = inp + acc[1, 0, -1]`` reaches one column further at every
    level; so does ``acc[1, 0, -1]`` read before this level's write) needs a
    neighbouring block's value of that level; K3's sequential grid finishes
    a whole plane before the next. Such a loop is *cooperative*: one
    ``cudaLaunchCooperativeKernel`` of as many blocks as are resident at
    once (at most one per tile; the launch fails, and the wrapper raises,
    where not one fits). Each block walks every level over its tiles in a
    fixed order; before a tile's level, its thread 0 waits (an acquire
    load, bounded by ``SPIN_POLLS`` and then ``__trap()``) until every tile
    that the level's reads of earlier levels reach, worked out from the
    read offsets and the statement extents in units of tiles, has published
    the level before; after the tile's stores, a barrier and thread 0's
    ``__threadfence()`` and release store publish its own. The counters are
    an int32 buffer from the wrapper that the launcher zeroes each call.
    Earlier levels are read from device memory through L2 (``__ldcg``),
    since L1 is not coherent across SMs within a launch; such a loop has no
    input ring and no carries. Measured (PERF.md): the lagged sweeps
    take 391 and 424 µs of device time a call at 256×256×80 in float64,
    4.9-5.3 µs a level, against ≈ 470-870 µs with a launch per level.
    Bound on the H100: the dependent K chain, as for ``column``, plus the
    halo recompute; the grid has one block per tile, so the tile is kept
    small to give every SM work. Measured: smoothed_column_sum 66.3 µs a
    step in float32 and 61.6 in float64 at 256×256×80 (before the ring, the
    barrier rule and the carries: 117.3, 141.6),
    against a bound of 12.5 and 25.0; ≈ 0.8 µs a level in either type and
    at every tile shape measured, so a level's work on the SM, not its
    bytes, holds it.

Numerics follow c_codegen.py: NumPy floor-mod, true division, NaN-
propagating min/max, banker's round. The build uses ``--fmad=false``
(cuda_backend.py), so products and sums round as in the eager plain
version. Arguments may alias (``stencil(a, a)``), so the kernels take plain
pointers; every kernel also has a second, ``_r`` variant that the wrapper
launches when it has checked that no two field buffers overlap.
A shared plane of an API field that ``fused_plane`` or ``tiled`` first
loads from device memory at a level, and that a statement reads at other
points before or in the level's last write of it, is loaded from a
snapshot the wrapper copies before the launch (``KernelModule.snapshots``):
a neighbouring block may already have stored its own points of that level.
float16 and bfloat16 fields are stored half and computed in float32, as
K1 computes them (pallas_split.py:129-156): a half element is loaded with
``__half2float`` or ``__bfloat162float`` and stored with
``__float2half_rn`` or ``__float2bfloat16_rn``; temporaries, literals,
casts and math calls of a half type are float ones; a half field is
ringed only by plane's register patches, in whole vectors of 2 or more
elements (``cp.async`` copies 4, 8 or 16 bytes).
Constructs no skeleton can serve raise :class:`CudaUnsupported` with the
reason; there is no silent fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

from gt4py_tpu_torch.cartesian import gtir
from gt4py_tpu_torch.cartesian.definitions import Extent
from gt4py_tpu_torch.cartesian.passes.extents import _iter_reads, iter_writes
from gt4py_tpu_torch.cartesian.passes.pipeline import AnalyzedStencil
from gt4py_tpu_torch.cartesian.passes.type_inference import comparison_dtype
from gt4py_tpu_torch.core.definitions import HALF_FLOAT_DTYPES, bfloat16, is_float_dtype

#: fused_plane tile: TI rows of I by TJ columns of J, and its thread count
TI, TJ = 16, 64
PLANE_THREADS = 256
#: plane kernel: its tile, PL_TI rows of I by PL_TJ columns of J, the
#: levels PL_TK a block walks over it, and its PL_THREADS threads: a row of
#: PL_TJ along J, and rows of I that a statement's rows are walked by.
#: Tuned on the card for the sum of hdiff's float32 and float64 device
#: times (PERF.md, a mode of chip_smoke.py since removed): 16 × 64 over 8 ×
#: 64, 32 × 64, 16 × 32, 8 × 128 and 32 × 32; 4 levels over 1, 2, 8 and 16;
#: 256 threads over 128 and 512; no register cap over 5, 6 or 8 blocks an
#: SM. The register patches (``_r``, float32 µs a step) kept them:
#: 16 × 64 over 32 × 64 (29.98 against 36.28), 4 levels over 2 and 8
#: (32.21, 33.63), 256 threads over 512 (39.64)
PL_TI, PL_TJ = 16, 64
PL_TK = 4
PL_THREADS = 256
#: plane, ``_r`` variant (register patches), tuned on the card for hdiff at
#: 256×256×80 in float32, float64, float16 and bfloat16 (PERF.md §6;
#: device µs a step, float32 / float64 / float16): a thread's patch,
#: PL_PATCH_WIDTH J points by PL_PATCH_ROWS rows of I, at most 16 bytes of
#: the loop's widest field (float64: 2 × 1), 2 × 2 (29.98 / 57.23 / 32.55)
#: over 4 × 1, one 16-byte float32 vector (37.84 / - / 43.83), 8 × 1 (- /
#: - / 54.43), 2 × 1 (31.40 / 57.23 / 38.08) and 2 × 4 (45.95 / - / 36.50);
#: PL_PATCH_BLOCKS blocks an SM, to which ``__launch_bounds__`` holds the
#: registers: 4 (63 registers) over none (91, 2 blocks: 45.11 / 58.89),
#: 5 and 6 (float64 spills); the most levels the input ring holds, 3 over
#: 2 and 4 (float64 keeps 2 by ``TILE_RESIDENT_THREADS``)
PL_PATCH_WIDTH = 2
PL_PATCH_ROWS = 2
PL_PATCH_BLOCKS = 4
PL_RING_LEVELS = 3
#: column-kernel block: (32 along J) × (8 along I) columns
COL_BJ, COL_BI = 32, 8
#: shared memory a kernel takes without ``cudaFuncSetAttribute``, and the
#: most a plane block may use for its temporaries (K1's class)
SHARED_BYTES_MAX = 48 * 1024
#: dynamic shared memory a block may use on the H100 (232,448 bytes)
SHARED_BYTES_LIMIT = 227 * 1024
#: fused_plane: levels a block walks; its tile and block are the plane
#: kernel's. Measured on the H100 for hdiff_sponge (PERF.md): 4 levels beat
#: 1, 2 and 8; 16 × 64 beat 8 × 64, 8 × 32 and 16 × 32, and 512 threads.
#: With the input ring (``chip_smoke.py --tile-variants``, PERF.md;
#: f32 / f64 device µs at 256×256×80, ring depth 4): 4 levels 64.8 / 84.1,
#: 8 levels 65.9 / 87.1, 16 levels 80.3 / 108.1, all 80 (64 blocks)
#: 209.3 / 236.5; at depths 2 and 3 too, 4 levels won or tied
FP_TK = 4
#: tiled-kernel tile and block: one block per tile and no K blocks, so a
#: small tile keeps every SM busy (256 blocks at 256 × 256); enough threads
#: that one pass covers the widened tile of a statement with a halo of 1.
#: Measured on the H100 for smoothed_column_sum (PERF.md): 8 × 32 with 512
#: threads beat 8 × 32 with 256, 4 × 32, 2 × 32, 4 × 16, 16 × 16 and 4 × 64
TL_TI, TL_TJ = 8, 32
TILED_THREADS = 512
#: fused_column: threads (columns) per block, 32 along J. Measured on the
#: H100 for vadv and tridiag (PERF.md): 256 beat 64 and 128 for vadv
#: float32 and tied elsewhere
FC_THREADS = 256
#: column and fused_column, ``__restrict__`` variants: how far a walk's
#: prefetch ring runs ahead. At level k a thread starts the copies of level
#: k + RING_LEVELS - 1; the ring holds RING_LEVELS slots plus one for each
#: level behind the walk its reads reach. Measured on the H100 for vadv and
#: tridiag on both kernels in float32 and float64 (PERF.md): 4 beat 2, 8
#: and 16 on the sum of the eight cells, and in six of them
RING_LEVELS = 4
#: column: a FORWARD loop and the BACKWARD loop after it in one launch, the
#: values the second reads from the first in a shared-memory slab
#: (:meth:`_Generator._plan_on_chip`). Its block: 32 columns along J by
#: ON_CHIP_ROWS along I; the depths of its FORWARD and BACKWARD walks' rings
#: (the slab leaves fewer columns resident than ``column``'s two kernels do,
#: so each column keeps more levels in flight). Measured on the H100 for
#: vadv float32 at 256×256×80 (PERF.md; µs a step, chains of 200, the two
#: kernels 83.8-84.0): 2 rows with depths (8, 16) 64.6-65.1, (8, 8)
#: 64.5-65.0, (8, 24) 68.3, (6, 16) 66.3-66.5, (9, 8) 65.9-67.4; 4 rows
#: (8, 16) 64.9-65.3, (6, 16) 66.4-66.7, (4, 16) 73.2-73.4; 1 row (8, 16)
#: 65.2; 8 rows (6, 16) 66.3-66.9
ON_CHIP_ROWS = 2
ON_CHIP_RING_LEVELS = (8, 8)
#: the launcher takes the one-launch pair only where its slab and ring leave
#: enough columns resident on an SM that a level of them, at the item size
#: of the fields the walks stream, is at least this many bytes, and the two
#: ``column`` kernels otherwise. Measured on the H100 (PERF.md; vadv at
#: 256×256×nk, µs a step, pair against the two kernels; resident columns ×
#: item size): float32 nk 80, 256 × 4 B: 66.3 against 85.4; nk 100, 192 ×
#: 4: 101.6 against 106.1; nk 120, 192 × 4: 119.7 against 125.2; nk 160, 128
#: × 4: 191-194 against 165-167; float64 nk 60, 128 × 8: 88.6 against
#: 113.7; nk 80, 128 × 8: 117.9 against 152.1; nk 100, 64 × 8: 243.1
#: against 190.8; nk 160, 64 × 8: 385 against 307. At 512 bytes the pair
#: lost in every cell measured, at 768 and above in none
ON_CHIP_RESIDENT_BYTES = 768
#: the most dynamic shared memory a ring may take per block: two blocks of
#: a 256×256 grid on each SM (228 KB, 1 KB of it reserved per block), so
#: that every block is resident at once. A walk whose streams would take
#: more rings only those that fit, in the order it first reads them, and
#: loads the rest directly
RING_BYTES_MAX = 113 * 1024
#: tiled and fused_plane: the most levels of the input-plane ring. At level
#: k a block starts the copies of level k + depth - 1; each ringed field
#: holds depth planes plus one for each level behind the walk its reads
#: reach. Measured on the H100 (PERF.md, a ``chip_smoke.py`` mode since
#: removed; device µs at 256×256×80, FP_TK = 4, hdiff_sponge f32, f64,
#: smoothed_column_sum f32, f64): depth 2 67.6, 71.5, 68.2, 77.3; depth 3
#: 66.3, 74.8, 70.5, 76.3; depth 4 64.8, 84.1, 66.3, 61.6
TILE_RING_LEVELS = 4
#: an H100 SM's shared memory, and what each resident block reserves of it
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
#: tiled and fused_plane: a ring takes fewer levels, down to 2, where its
#: block's shared memory would leave fewer threads than this resident on an
#: SM. In the measurements above, hdiff_sponge f64 (256 threads a block)
#: keeps 4 blocks at depth 2, 3 at depth 3 and 2 at depth 4, and was
#: fastest at 2; f32 keeps 4 at depth 4 and was fastest there
TILE_RESIDENT_THREADS = 1024
#: cooperative tiled loops: polls of a neighbour's level counter before the
#: kernel traps, so that a scheduling fault ends the launch with an error
#: instead of hanging it
SPIN_POLLS = 1 << 30
#: what a launcher returns when its grid is empty and no kernel ran
#: (``cudaError_t`` values are never negative)
NOTHING_LAUNCHED = -1


class CudaUnsupported(Exception):
    """A construct the generated kernels cannot serve (the message names
    it). The ``cuda:hopper`` backend raises it on CUDA tensors."""


_CTYPES = {
    "bool": "unsigned char",
    "int8": "int8_t",
    "int16": "int16_t",
    "int32": "int32_t",
    "int64": "int64_t",
    "uint8": "uint8_t",
    "uint16": "uint16_t",
    "uint32": "uint32_t",
    "uint64": "uint64_t",
    "float32": "float",
    "float64": "double",
}

_F32 = np.dtype(np.float32)
#: a half dtype -> its C type in device memory, and the intrinsics that
#: convert it to and from float (the only conversions the build allows:
#: ``-D__CUDA_NO_HALF_CONVERSIONS__ -D__CUDA_NO_BFLOAT16_CONVERSIONS__``)
_HALF_TYPES = {
    np.dtype(np.float16): ("__half", "__half2float", "__float2half_rn", "__ushort_as_half"),
    bfloat16: ("__nv_bfloat16", "__bfloat162float", "__float2bfloat16_rn", "__ushort_as_bfloat16"),
}
_BOOL = np.dtype(np.bool_)

#: NativeFunction -> CUDA math name (f64 variant; f32 appends 'f').
_LIBM = {
    gtir.NativeFunction.SIN: "sin",
    gtir.NativeFunction.COS: "cos",
    gtir.NativeFunction.TAN: "tan",
    gtir.NativeFunction.ASIN: "asin",
    gtir.NativeFunction.ACOS: "acos",
    gtir.NativeFunction.ATAN: "atan",
    gtir.NativeFunction.SINH: "sinh",
    gtir.NativeFunction.COSH: "cosh",
    gtir.NativeFunction.TANH: "tanh",
    gtir.NativeFunction.ASINH: "asinh",
    gtir.NativeFunction.ACOSH: "acosh",
    gtir.NativeFunction.ATANH: "atanh",
    gtir.NativeFunction.SQRT: "sqrt",
    gtir.NativeFunction.CBRT: "cbrt",
    gtir.NativeFunction.EXP: "exp",
    gtir.NativeFunction.LOG: "log",
    gtir.NativeFunction.LOG10: "log10",
    gtir.NativeFunction.GAMMA: "tgamma",
    gtir.NativeFunction.ERF: "erf",
    gtir.NativeFunction.ERFC: "erfc",
    gtir.NativeFunction.ATAN2: "atan2",
    gtir.NativeFunction.HYPOT: "hypot",
    gtir.NativeFunction.COPYSIGN: "copysign",
    gtir.NativeFunction.POW: "pow",
    gtir.NativeFunction.FMA: "fma",
    gtir.NativeFunction.FLOOR: "floor",
    gtir.NativeFunction.CEIL: "ceil",
    gtir.NativeFunction.TRUNC: "trunc",
    gtir.NativeFunction.ROUND: "rint",  # NumPy round = half-to-even
    gtir.NativeFunction.ROUND_AWAY_FROM_ZERO: "round",
}

_PRELUDE = r"""
#include <stdint.h>
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#define GT_D static __device__ __forceinline__
GT_D long long gt_clampk(long long k, long long n) {
    return k < 0 ? 0 : (k >= n ? n - 1 : k);
}
/* NumPy floor-mod: result sign follows the divisor. */
GT_D double gt_fmod_np(double a, double b) {
    double r = fmod(a, b);
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
GT_D float gt_fmodf_np(float a, float b) {
    float r = fmodf(a, b);
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
GT_D int64_t gt_imod_np(int64_t a, int64_t b) {
    int64_t r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
GT_D int64_t gt_ipow(int64_t base, int64_t e) {
    if (e < 0) return (int64_t)pow((double)base, (double)e);
    int64_t r = 1;
    while (e) { if (e & 1) r *= base; base *= base; e >>= 1; }
    return r;
}
/* NumPy minimum/maximum propagate NaN from either operand. */
GT_D double gt_fmin_np(double a, double b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
GT_D double gt_fmax_np(double a, double b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}
GT_D float gt_fminf_np(float a, float b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
GT_D float gt_fmaxf_np(float a, float b) {
    return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}
GT_D int gt_slot(long long k, int r) {
    const long long s = k % r;
    return (int)(s < 0 ? s + r : s);
}
GT_D int64_t gt_imin(int64_t a, int64_t b) { return a < b ? a : b; }
GT_D int64_t gt_imax(int64_t a, int64_t b) { return a > b ? a : b; }
"""

#: the prefetch ring (sources that have one): a ``cp.async`` of 4 or 8
#: bytes per element from device memory into the thread's own slot of
#: shared memory (a 32-bit shared address), one commit group per level, and
#: the ring's reads. Every one is a volatile asm, so the compiler keeps their
#: order (a read never moves above the wait that completes its copy, nor a
#: copy above the read of the slot it overwrites) without a "memory" clobber,
#: which would also stop it from keeping the thread's own stores to the
#: fields in registers across levels
_RING_PRELUDE = r"""GT_D void gt_cp_async4(unsigned dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src));
}
GT_D void gt_cp_async8(unsigned dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(dst), "l"(src));
}
GT_D void gt_cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> GT_D void gt_cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }
GT_D void gt_cp_wait_all() { asm volatile("cp.async.wait_all;\n"); }
#define GT_LDS(T, PTX, C) GT_D T gt_lds_##T(unsigned a) { \
    T v; asm volatile("ld.shared." PTX " %0, [%1];\n" : "=" C(v) : "r"(a)); return v; }
GT_LDS(float, "f32", "f")
GT_LDS(double, "f64", "d")
GT_LDS(int32_t, "b32", "r")
GT_LDS(uint32_t, "b32", "r")
GT_LDS(int64_t, "b64", "l")
GT_LDS(uint64_t, "b64", "l")
"""

#: plane's ``_r`` kernels (register patches): two floats rounded to float16
#: or bfloat16 and packed into the 32 bits of a vector store, by half type
#: (a source holds the ones its fields need), and (with an input ring) a
#: 16-byte ``cp.async``, the ring's vector copy
_PACK_PRELUDE = {
    np.dtype(np.float16): r"""GT_D unsigned gt_pack_h(float a, float b) {
    return (unsigned)__half_as_ushort(__float2half_rn(a))
        | ((unsigned)__half_as_ushort(__float2half_rn(b)) << 16);
}
""",
    bfloat16: r"""GT_D unsigned gt_pack_bf(float a, float b) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a))
        | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
""",
}
_RING16_PRELUDE = r"""GT_D void gt_cp_async16(unsigned dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}
"""

#: plane's ``_r`` kernels: the C vector type moving ``n`` elements of a C
#: type at once, by (C type, n); a half element moves as its 16 bits
_VECTORS = {
    ("float", 4): "float4", ("float", 2): "float2", ("double", 2): "double2",
    ("int32_t", 4): "int4", ("int32_t", 2): "int2",
    ("uint32_t", 4): "uint4", ("uint32_t", 2): "uint2",
    ("int64_t", 2): "longlong2", ("uint64_t", 2): "ulonglong2",
    ("unsigned short", 8): "uint4", ("unsigned short", 4): "uint2",
    ("unsigned short", 2): "unsigned",
}
#: the launcher's ``noalias`` word for a plane ``_r`` kernel
#: (:meth:`PatchLayout.word`): bit 0 the no-overlap flag, then the patch
#: grid's shift, then one bit a field for its vector path
PATCH_SHIFT_BITS = 3
PATCH_MASK_AT = 1 + PATCH_SHIFT_BITS
PATCH_MASK_FIELDS = 31 - PATCH_MASK_AT

#: cooperative tiled loops: a tile's level counter, published with release
#: semantics after the tile's stores and polled with acquire semantics by
#: the blocks whose reads reach the tile
_FLAG_PRELUDE = r"""GT_D int gt_flag_load(const int* f) {
    int v; asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory"); return v;
}
GT_D void gt_flag_store(int* f, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(f), "r"(v) : "memory");
}
"""


def _np_dtype(dtype: Any) -> np.dtype:
    if dtype is None:
        raise CudaUnsupported("expression with unresolved dtype")
    return np.dtype(dtype)


def _compute(dtype: Any) -> np.dtype:
    """The type a kernel computes a value of ``dtype`` in: float16 and
    bfloat16 in float32, as K1 computes half fields
    (pallas_split.py:129-156); every other type in itself."""
    dt = _np_dtype(dtype)
    return _F32 if dt in HALF_FLOAT_DTYPES else dt


def _is_f32(dtype: Any) -> bool:
    """Computed in float32: the float names of the math library apply."""
    return _compute(dtype) == _F32


def _ctype(dtype: Any) -> str:
    """The C type a value of ``dtype`` is computed and held on chip in
    (registers, shared memory, temporaries' buffers)."""
    dt = _compute(dtype)
    try:
        return _CTYPES[dt.name]
    except KeyError:
        raise CudaUnsupported(f"dtype {dt} has no kernel type yet") from None


def _stype(dtype: Any) -> str:
    """The C type of an API field's element in device memory: ``__half``
    for float16, ``__nv_bfloat16`` for bfloat16 (:data:`_HALF_TYPES`), else
    its compute type."""
    half = _HALF_TYPES.get(_np_dtype(dtype))
    return half[0] if half else _ctype(dtype)


def _load(m: "FieldMeta", addr: str, load: str = "", const: bool = False) -> str:
    """A read of ``m``'s element at byte address ``addr``, in its compute
    type; ``load``: through this intrinsic (a half element as its 16 bits)."""
    half = _HALF_TYPES.get(_np_dtype(m.dtype))
    if half:
        st, to_float, _, from_bits = half
        if load:
            return f"{to_float}({from_bits}({load}((const unsigned short*)({addr}))))"
        return f"{to_float}(*(const {st}*)({addr}))"
    st = _stype(m.dtype)
    if load:
        return f"{load}((const {st}*)({addr}))"
    return f"(*({'const ' if const else ''}{st}*)({addr}))"


def _raw(dtype: Any) -> str:
    """The C type that moves an element of ``dtype`` as it lies in device
    memory: a half element as its 16 bits."""
    return "unsigned short" if _np_dtype(dtype) in _HALF_TYPES else _stype(dtype)


def _chunks(ct: str, size: int, width: int) -> tuple[Optional[str], int]:
    """A row of ``width`` elements of C type ``ct`` (``size`` bytes each) as
    vectors: (the vector type, the elements in one), at most 16 bytes a
    vector; (None, 1) where the row moves element by element."""
    n = min(width, 16 // size)
    vt = _VECTORS.get((ct, n))
    return (vt, n) if vt and width >= 2 else (None, 1)


def patch_shift(width: int, itemsize: int, address: int, strides) -> Optional[int]:
    """plane's ``_r`` kernel: how many elements past a boundary of ``width``
    elements (one vector) a field's element at the domain's origin lies,
    ``address`` its byte address; None where the field keeps the per-point
    path: a J stride that is not the item size, or row or level pitches
    (``strides``: bytes along I, J, K) that are not whole vectors."""
    si, sj, sk = strides
    vector = width * itemsize
    if width < 2 or sj != itemsize or address % itemsize or si % vector or sk % vector:
        return None
    return address % vector // itemsize


@dataclasses.dataclass(frozen=True)
class PatchLayout:
    """plane's ``_r`` kernel of one loop: a thread computes patches of
    ``width`` J points, a vector of each field, by one or more rows of I
    (:meth:`_Generator._plan_patch`). ``fields`` (name, item size): the
    fields with a vector path, in the order of the launcher's mask."""

    width: int
    fields: tuple[tuple[str, int], ...]

    def word(self, noalias: int, layouts: dict) -> int:
        """The launcher's ``noalias`` argument: 0 (the plain-pointer
        kernel) where the buffers overlap or a half field is off the
        tiles' vectors (element by element, the patches read it slower
        than that kernel), else bit 0, the shift of the tiles along J (the
        first field's with a vector path, so that its tiles start on
        vectors), and a bit for each field whose vectors start there too.
        ``layouts``: field -> (the byte address of its element at the
        domain's origin, its byte strides along I, J, K)."""
        if not noalias:
            return 0
        shifts = [
            patch_shift(self.width, size, *layouts[name]) if name in layouts else None
            for name, size in self.fields
        ]
        s = next((x for x in shifts if x is not None), 0)
        on = [x is not None and x == s for x in shifts]
        if any(size == 2 and name in layouts and not ok
               for (name, size), ok in zip(self.fields, on)):
            return 0
        mask = sum(1 << b for b, ok in enumerate(on) if ok)
        return 1 | s << 1 | mask << PATCH_MASK_AT

    def patched(self, word: int) -> bool:
        """Every field of the launch takes its vector path."""
        every = (1 << len(self.fields)) - 1
        return bool(word & 1) and bool(self.fields) and (word >> PATCH_MASK_AT) & every == every


def _column_passes(cols: int, threads: int) -> list[tuple[int, str]]:
    """The passes a row of ``threads`` threads makes over ``cols``
    columns: (the pass's first column, the condition a thread's column
    meets, "" where every thread's does)."""
    return [
        (c0, "" if c0 + threads <= cols else f"if (tx < {cols - c0})")
        for c0 in range(0, cols, threads)
    ]


@dataclasses.dataclass
class FieldMeta:
    """Per-symbol layout info shared by codegen and the launching wrapper.

    API fields, tables and (column kernel) global temporaries each take one
    slot of the launch arguments: a base pointer, ``ndim`` shape/stride
    entries from ``shape_off`` on, and an (I, J, K) origin triple."""

    name: str
    var: str
    dtype: np.dtype
    axes: tuple[bool, bool, bool]  # (I, J, K) presence; tables: all False
    data_dims: tuple[int, ...]
    index: int = -1  # slot in the launch arguments (-1: shared-memory temp)
    shape_off: int = -1
    is_temp: bool = False
    extent: Optional[Extent] = None  # temps only
    #: global temporaries: the wrapper zero-fills the buffer (the kernel
    #: may read a point before it writes it)
    fill: bool = True
    #: a snapshot: the wrapper copies this symbol's buffer into the slot's
    #: own, of the same layout, before each launch that reads it
    snapshot_of: Optional[str] = None

    @property
    def ndim(self) -> int:
        return sum(self.axes) + len(self.data_dims)


@dataclasses.dataclass(frozen=True)
class OnChip:
    """column: a FORWARD loop's launcher that also serves the BACKWARD loop
    after it, in one launch of ``kernel``, for arguments that do not
    overlap and a domain of at most ``max_nk`` levels (:meth:`serves`). The
    values the BACKWARD walk reads from the FORWARD one (``cross``) then live
    in the block's shared memory, never in device memory: a slab of
    ``level_bytes`` a level, after ``ring_bytes`` of prefetch ring. The
    BACKWARD loop's own launcher launches nothing then."""

    kernel: str
    cross: tuple[str, ...]
    ring_bytes: int
    level_bytes: int
    max_nk: int

    def serves(self, nk: int, noalias: bool) -> bool:
        return bool(noalias) and nk <= self.max_nk

    def shared_bytes(self, nk: int) -> int:
        """Dynamic shared memory of a block at ``nk`` levels."""
        return self.ring_bytes + nk * self.level_bytes


@dataclasses.dataclass
class KernelModule:
    """Generated source plus what the launching wrapper needs."""

    strategy: str  # "plane" | "fused_plane" | "column" | "fused_column" | "tiled"
    source: str
    #: launch slots in order: API fields and tables, then global temporaries
    slots: list[FieldMeta]
    scalars: list[tuple[str, str, int, np.dtype]]  # (name, 'f'|'i', slot, dtype)
    n_shape_slots: int
    #: extern "C" launcher names in launch order: one per vertical loop, or
    #: one per stencil (fused_plane, fused_column)
    launchers: list[str]
    #: API fields the stencil writes
    written: frozenset[str] = frozenset()
    #: API fields some thread reads at a point another thread may write:
    #: at a horizontal offset, from a widened statement, at a K offset in a
    #: PARALLEL loop of the column or tiled kernel, or from a copy staged in
    #: shared memory (fused_plane). If one of these shares memory with a
    #: written field, the kernels would race.
    nonlocal_reads: frozenset[str] = frozenset()
    #: written field -> domain axes ("I", "J", "K") it lacks that the
    #: kernel can only serve at size 1: every block along such an axis
    #: would store to the same element
    unit_axes: dict[str, str] = dataclasses.field(default_factory=dict)
    #: fused_column: the smallest K the kernel serves (a carry read must
    #: not reach before its walk's first level)
    min_nk: int = 0
    #: launchers of a cooperative kernel (tiled loops whose levels wait on
    #: neighbouring tiles): each takes a trailing ``int*``, the tiles' level
    #: counters, an int32 buffer of ``tiles(ni, nj)`` elements the wrapper
    #: allocates and the launcher zeroes
    cooperative: frozenset[str] = frozenset()
    #: kernel -> the bytes of dynamic shared memory its prefetch ring takes
    #: per block (column and fused_column: ``__restrict__`` variants; tiled
    #: and fused_plane: the input-plane ring)
    ring_bytes: dict[str, int] = dataclasses.field(default_factory=dict)
    #: the tiled kernels' tile (rows of I, columns of J) the source was
    #: generated for
    tile: tuple[int, int] = (0, 0)
    #: launcher -> the symbols the wrapper snapshots before launching it
    #: (their ``snapshot_of`` slots)
    snapshots: dict[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)
    #: plane: the rows of I and columns of J that a block's 32-bit point
    #: offsets reach from its tile's corner (statements widened by their
    #: extents, ring planes by their footprints); the wrapper refuses a
    #: field whose strides carry them beyond 32 bits
    offset_span: tuple[int, int] = (0, 0)
    #: column: FORWARD loops' launchers that also serve the BACKWARD loop
    #: after them in one launch, where the shape lets them
    on_chip: dict[str, OnChip] = dataclasses.field(default_factory=dict)
    #: plane: each launcher's register patches (its ``_r`` kernel), from
    #: which the wrapper makes the launcher's ``noalias`` word
    patches: dict[str, PatchLayout] = dataclasses.field(default_factory=dict)

    def kernels_per_call(self, nk: int, noalias: bool) -> int:
        """The kernels a call launches on a domain of ``nk`` levels whose
        grids are not empty: one a launcher, less one for each on-chip pair
        that serves the shape."""
        return len(self.launchers) - sum(oc.serves(nk, noalias) for oc in self.on_chip.values())

    def tiles(self, ni: int, nj: int) -> int:
        """Tiles of a tiled kernel's grid over an ni × nj domain."""
        return -(-ni // self.tile[0]) * -(-nj // self.tile[1])


def _is_k_shift(acc: gtir.FieldAccess) -> bool:
    return acc.offset[2] != 0 or acc.koffset is not None or acc.abs_k is not None


def _nonlocal_reads(
    analyzed: AnalyzedStencil, strategy: str, staged: frozenset[str] = frozenset()
) -> frozenset[str]:
    params = set(analyzed.field_infos)
    # one element of a lower-dimensional field or table is read at many
    # points, so a written field sharing its memory races with some reader
    lower = {
        n for n, info in analyzed.field_infos.items() if info is not None and len(info.axes) < 3
    }
    out = set(staged)
    widened = strategy in ("plane", "fused_plane", "tiled")
    k_walk = strategy in ("column", "fused_column", "tiled")
    for vloop in analyzed.stencil.vertical_loops:
        parallel = vloop.loop_order == gtir.LoopOrder.PARALLEL
        for section in vloop.sections:
            for stmt in section.body:
                ext = analyzed.stmt_extents[stmt]
                wide = widened and (ext.i != (0, 0) or ext.j != (0, 0))
                for r in _iter_reads(stmt):
                    if r.name in params and (
                        r.offset[0] != 0
                        or r.offset[1] != 0
                        or wide
                        or r.name in lower
                        or (parallel and k_walk and _is_k_shift(r))
                    ):
                        out.add(r.name)
    return frozenset(out)


def generate(analyzed: AnalyzedStencil, *, fuse_stages: bool = False) -> KernelModule:
    """The kernels of the first skeleton that serves the stencil (its name
    in ``.strategy``); raises :class:`CudaUnsupported` with every
    skeleton's reason when none does. ``fuse_stages`` is the stage-fusion
    switch: where ``column`` serves the stencil, ``fused_column`` does
    instead if the stencil is of K4's class."""
    return _Generator(analyzed, fuse_stages=fuse_stages).generate()


@dataclasses.dataclass
class _Item:
    """One top-level statement of a kernel's scope, in program order."""

    pos: int
    section: int  # index of its section, unique across the stencil
    interval: gtir.Interval
    stmt: gtir.Stmt
    ext: Extent
    reads: list
    writes: list
    loop: int = 0  # index of its vertical loop

    @property
    def wide(self) -> bool:
        return self.ext.i != (0, 0) or self.ext.j != (0, 0)

    def writes_name(self, name: str) -> bool:
        return any(w.name == name for w in self.writes)


@dataclasses.dataclass
class _Buffer:
    """A symbol held in shared memory by a fused_plane or tiled block:
    ``shared`` (a temporary or a written API field read at other points),
    ``staged`` (a read-only IJ field, loaded once), ``table``, or ``input``
    (a ring of planes of a 3-D field the walk reads, copied ahead). Planes
    cover the tile widened by the footprint ``fp``; a ring holds ``ring``
    planes; each point holds ``nd`` data-dimension elements."""

    meta: FieldMeta
    kind: str
    fp: Extent
    rows: int = 0
    cols: int = 0
    nd: int = 1
    ring: int = 1
    offset: int = 0  # bytes into the block's dynamic shared memory
    #: sections (indices) at whose levels the plane is first filled from
    #: its home (device memory, or zeros for a fused_plane temporary)
    init: frozenset[int] = frozenset()
    #: tiled: the sections that write the symbol, whose levels the ring holds
    writers: frozenset[int] = frozenset()
    #: kind "input" (a ringed input's planes): the reads it serves, per
    #: statement (``id``), as (name, offset)
    serves: dict = dataclasses.field(default_factory=dict)
    #: plane's ``_r`` variant, kind "input": the footprint of the reads it
    #: serves, which the block copies (rounded out to whole vectors); its
    #: plane (``fp``) also spans what the patches read beyond it
    fill: Optional[Extent] = None

    @property
    def plane(self) -> int:
        return self.rows * self.cols

    @property
    def elements(self) -> int:
        if self.kind == "table":
            return int(np.prod(self.meta.data_dims)) if self.meta.data_dims else 1
        return self.plane * self.nd * self.ring

    @property
    def size(self) -> int:
        """An element's bytes: the compute type's, a ring's raw ones (a
        half field's 2, in plane's ``_r`` variant)."""
        return (self.meta.dtype if self.kind == "input" else _compute(self.meta.dtype)).itemsize

    @property
    def bytes(self) -> int:
        """Its bytes of dynamic shared memory, 16-byte aligned."""
        return -(-self.elements * self.size // 16) * 16


@dataclasses.dataclass
class _PatchPlan:
    """plane's ``_r`` kernel of one loop. A thread computes a statement
    over patches of ``width`` J points by ``rows`` rows of I, over
    ``regions[id(stmt)]``: (first row, end row, first column, end column)
    from the tile's corner, the statement's extent rounded out to whole
    patches (its columns to whole vectors of the storage: the tiles start on
    them). ``planes``: the temporaries' shared planes, ``ring``: the input
    ring's, each spanning what the patches touch; ``fields``: the API
    fields with a vector path, in the launcher's mask order."""

    width: int
    rows: int
    regions: dict
    planes: list
    ring: list
    fields: list
    bytes: int = 0


@dataclasses.dataclass
class _Held:
    """column and fused_column: a temporary kept on chip, a register in the
    loop that writes it, with ``ring`` registers for the levels that loop
    reads back, started at 0 at the levels of the sections in ``reset``. A
    value a later loop reads (``cross``) is also stored per level to a
    (K, I, J) buffer."""

    meta: FieldMeta
    writer: int
    ring: int = 0
    reset: frozenset[int] = frozenset()
    cross: bool = False


@dataclasses.dataclass
class _Stream:
    """One (field, horizontal offset) a walk's prefetch ring copies, level
    by level, at the points of ``ext`` (the statements that read it)."""

    meta: FieldMeta
    di: int
    dj: int
    ext: Extent
    offset: int = 0  # bytes into a slot
    pitch: int = 0  # bytes from one thread's element to the next one's


@dataclasses.dataclass
class _Ring:
    """The prefetch ring of one FORWARD or BACKWARD walk: ``slots`` levels
    of every stream in dynamic shared memory, laid out [slot][stream][thread]
    so that a warp's copies and reads hit consecutive banks. Its reads reach
    ``back`` levels behind the walk and ``ahead`` levels ahead; ``reads``
    holds, per statement (``id``), the reads it serves as (name, offset)."""

    streams: list[_Stream]
    back: int
    ahead: int
    backward: bool
    reads: dict[int, frozenset]
    slot_bytes: int
    #: how far it runs ahead: at level k the copies of k + levels - 1 start
    levels: int = RING_LEVELS

    @property
    def slots(self) -> int:
        return self.levels + self.back

    @property
    def bytes(self) -> int:
        return self.slots * self.slot_bytes

    def stream(self, name: str, di: int, dj: int) -> int:
        return next(
            n for n, s in enumerate(self.streams) if (s.meta.name, s.di, s.dj) == (name, di, dj)
        )


def _ring_blocks(ring) -> str:
    """A ringed kernel's blocks per SM for ``__launch_bounds__``: a
    256×256 grid runs two blocks of 256 columns on each SM at once. Without
    the hint ptxas may hold a small ringed kernel to 32 registers and spill
    (forward_cumsum, PERF.md)."""
    return ", 2" if ring else ""


def _bound_le(a: gtir.AxisBound, b: gtir.AxisBound) -> bool:
    """a <= b for every domain size."""
    return a.level == b.level and a.offset <= b.offset


def _interval_within(inner: gtir.Interval, outer: gtir.Interval) -> bool:
    return _bound_le(outer.start, inner.start) and _bound_le(inner.end, outer.end)


def _shifted(iv: gtir.Interval, dk: int) -> gtir.Interval:
    return gtir.Interval(
        start=gtir.AxisBound(level=iv.start.level, offset=iv.start.offset + dk),
        end=gtir.AxisBound(level=iv.end.level, offset=iv.end.offset + dk),
    )


def _covers(ext: Extent, fp: Extent) -> bool:
    return ext.i[0] <= fp.i[0] and ext.i[1] >= fp.i[1] and ext.j[0] <= fp.j[0] and (
        ext.j[1] >= fp.j[1]
    )


def _full_write(it: _Item, name: str) -> bool:
    """The statement writes every point of ``name``'s plane it spans,
    unconditionally."""
    s = it.stmt
    return (
        isinstance(s, gtir.Assign)
        and s.target.name == name
        and s.mask is None
        and not s.horizontal_masks
        and not s.target.data_index
        and s.target.offset == (0, 0, 0)
        and s.target.koffset is None
    )


def _is_carry(carries: dict, r: gtir.FieldAccess, backward: bool) -> bool:
    """tiled: a read of a carried value at the thread's own point, a
    constant number of levels behind the walk."""
    dk = r.offset[2]
    return (
        r.name in carries
        and r.offset[:2] == (0, 0)
        and dk != 0
        and (dk > 0) == backward
        and r.koffset is None
        and r.abs_k is None
        and not r.data_index
    )


def _loop_symbols(vloop: gtir.VerticalLoop):
    """(writes, reads) of one vertical loop, as FieldAccess lists."""
    writes, reads = [], []
    for section in vloop.sections:
        for stmt in section.body:
            writes.extend(iter_writes(stmt))
            reads.extend(_iter_reads(stmt))
    return writes, reads


class _Generator:
    def __init__(self, analyzed: AnalyzedStencil, *, fuse_stages: bool = False):
        self.analyzed = analyzed
        self.stencil = analyzed.stencil
        self.fuse_stages = fuse_stages
        self.strategy = ""
        self.fields: dict[str, FieldMeta] = {}
        self.slots: list[FieldMeta] = []
        self.scalars: list[tuple[str, str, int, np.dtype]] = []
        self.scalar_vars: dict[str, str] = {}
        self.lines: list[str] = []
        self.indent = 0
        #: name -> variable holding the field's byte address at the current
        #: point, (i, j[, k]); an access adds its constant offsets to it
        self.point_base: dict[str, str] = {}
        #: column kernel, alias-free variant: symbols read but not written
        #: by the loop, accessed through ``const`` pointers
        self.read_only: set[str] = set()

        shape_off = 0
        f_slot = i_slot = 0
        for p in self.stencil.params:
            if isinstance(p, (gtir.FieldDecl, gtir.GlobalTableDecl)):
                table = isinstance(p, gtir.GlobalTableDecl)
                meta = FieldMeta(
                    name=p.name,
                    var=f"f{len(self.slots)}",
                    dtype=_np_dtype(p.dtype),
                    axes=(False, False, False) if table else tuple(p.dimensions),
                    data_dims=tuple(p.shape) if table else tuple(p.data_dims),
                    index=len(self.slots),
                    shape_off=shape_off,
                )
            elif isinstance(p, gtir.ScalarDecl):
                dt = _np_dtype(p.dtype)
                _ctype(dt)
                if is_float_dtype(dt):
                    self.scalars.append((p.name, "f", f_slot, dt))
                    f_slot += 1
                else:
                    self.scalars.append((p.name, "i", i_slot, dt))
                    i_slot += 1
                self.scalar_vars[p.name] = f"sc_{p.name}"
                continue
            else:
                raise CudaUnsupported(f"parameter kind {type(p).__name__}")
            _ctype(meta.dtype)
            self.fields[p.name] = meta
            self.slots.append(meta)
            shape_off += meta.ndim

        for ti, t in enumerate(self.stencil.temporaries):
            if t.data_dims:
                raise CudaUnsupported(f"temporary '{t.name}' with data dimensions")
            meta = FieldMeta(
                name=t.name,
                var=f"t{ti}",
                # a half temporary lives in its compute type everywhere,
                # buffers in device memory included (K1, pallas_split.py:720)
                dtype=_compute(t.dtype),
                axes=(True, True, True),
                data_dims=(),
                is_temp=True,
                extent=analyzed.field_extents.get(t.name, Extent.zeros()),
            )
            _ctype(meta.dtype)
            self.fields[t.name] = meta
        #: fused_plane and tiled: name -> shared-memory buffer of the kernel
        #: being emitted, and that kernel's buffers by plan
        self.buffers: dict[str, _Buffer] = {}
        self.fused_plan: Optional[list[_Buffer]] = None
        self.tiled_plans: list[list[_Buffer]] = []
        #: plane: each loop's shared planes (its temporaries), their bytes,
        #: and the reach of the point offsets (KernelModule.offset_span)
        self.plane_plans: list[list[_Buffer]] = []
        #: plane: each loop's ``_r`` kernel (register patches), and while one
        #: of its statements is emitted, the patch point (row, column) whose
        #: reads are registers
        self.patch_plans: list[_PatchPlan] = []
        self.patch_point: Optional[tuple[int, int]] = None
        #: fused_plane and tiled: kernel index -> the symbols whose shared
        #: planes it loads from a snapshot of their values before the
        #: launch (:meth:`_load_hazard`), and each one's snapshot slot
        self.snapshots: dict[int, set[str]] = {}
        self.snapshot_meta: dict[str, FieldMeta] = {}
        self.plane_bytes: dict[int, int] = {}
        self.offset_span = (0, 0)
        #: dynamic shared memory of the fused_plane kernel, of each tiled one
        self.fused_bytes = 0
        self.tiled_bytes: dict[int, int] = {}
        #: tiled: the statement being emitted, its loop's sections, and the
        #: symbols its section writes
        self.item: Optional[_Item] = None
        self.loop_sections: list[tuple[int, gtir.Interval]] = []
        self.section_writes: set[str] = set()
        #: tiled: the loops whose levels wait on neighbouring tiles (one
        #: cooperative launch each), each loop's own-column carries (name ->
        #: (depth, statement extent)), and the temporaries no kernel reads
        #: from device memory (no buffer)
        self.cooperative: set[int] = set()
        self.tiled_carries: dict[int, dict[str, tuple[int, Extent]]] = {}
        self.carries: dict[str, tuple[int, Extent]] = {}
        self.no_buffer: set[str] = set()
        #: tiled and fused_plane: each kernel's input-plane ring (planner
        #: output, kernel index -> buffers of kind "input"), and whether the
        #: variant being emitted is the ``_r`` one (ring and API-field carries)
        self.tile_rings: dict[int, list[_Buffer]] = {}
        self.noalias = False
        #: cooperative tiled kernels: fields read from L2 (``__ldcg``), since
        #: another SM may have written them during the launch
        self.coherent: set[str] = set()
        #: column and fused_column: what is kept on chip, the loop being
        #: emitted, and the smallest K served
        self.held: dict[str, _Held] = {}
        #: column and fused_column: temporary -> whether the wrapper
        #: zero-fills its buffer
        self.fill: dict[str, bool] = {}
        self.loop = -1
        self.min_nk = 0
        #: column and fused_column, ``__restrict__`` variants: the ring of
        #: the walk being emitted, the reads it serves in the statement
        #: being emitted, and each kernel's ring bytes
        self.ring: Optional[_Ring] = None
        self.ring_reads: frozenset = frozenset()
        self.ring_bytes: dict[str, int] = {}
        #: column: the pairs of loops one launch may serve (FORWARD loop ->
        #: the values kept in the slab, :meth:`_plan_on_chip`), those it does
        #: (-> their OnChip), and, while one is emitted, its slab: value ->
        #: its byte offset in a level, and a level's bytes
        self.pairs: dict[int, tuple[str, ...]] = {}
        self.on_chip: dict[int, OnChip] = {}
        self.slab: dict[str, int] = {}
        self.slab_level = 0
        #: column: FORWARD loop -> the pair kernel's arguments and columns
        self.on_chip_launch: dict[int, tuple[str, Extent]] = {}
        self.strategy = self._choose()
        if self.strategy == "column":
            self.held, self.fill, _ = self._plan_held(fused=False)
            self.pairs = self._plan_on_chip()
        for meta in self.fields.values():  # global (K, I, J) buffers
            h = self.held.get(meta.name)
            if meta.is_temp and (
                (self.strategy == "tiled" and meta.name not in self.no_buffer)
                or (self.strategy in ("column", "fused_column") and (h is None or h.cross))
            ):
                meta.index = len(self.slots)
                meta.shape_off = shape_off
                meta.fill = self.fill.get(meta.name, True)
                self.slots.append(meta)
                shape_off += 3
        for name in sorted(set().union(*self.snapshots.values())):
            m = self.fields[name]
            snap = dataclasses.replace(
                m, name=f"{name}.before", var=f"s{len(self.snapshot_meta)}", index=len(self.slots),
                shape_off=shape_off, is_temp=False, snapshot_of=name,
            )
            self.snapshot_meta[name] = snap
            self.slots.append(snap)
            shape_off += snap.ndim
        self.n_shape_slots = shape_off

    # -- dispatch --------------------------------------------------------------

    def _choose(self) -> str:
        """The dispatch of pallas_codegen.build_pallas_fn (:400-512): K1's
        class, K2's, K3's, then K5."""
        loops = self.stencil.vertical_loops
        reasons = []
        plane_class = all(v.loop_order == gtir.LoopOrder.PARALLEL for v in loops) and not any(
            _is_k_shift(acc)
            for _, _, stmt in self.stencil.walk_stmts()
            for acc in _iter_reads(stmt)
        )
        if plane_class:
            try:
                self._check_plane_class()
                self.plane_plans = [self._plan_plane(n) for n in range(len(loops))]
                self.patch_plans = [self._plan_patch(n) for n in range(len(loops))]
                return "plane"
            except CudaUnsupported as exc:
                reasons.append(f"plane: {exc}")
            try:
                self.fused_plan = self._plan_fused()
                return "fused_plane"
            except CudaUnsupported as exc:
                reasons.append(f"fused_plane: {exc}")
        try:
            for vloop in loops:
                self._check_column(vloop)
        except CudaUnsupported as exc:
            reasons.append(f"column: {exc}")
        else:
            if self.fuse_stages:
                try:
                    self.held, self.fill, self.min_nk = self._plan_fused_column()
                    return "fused_column"
                except CudaUnsupported:
                    pass  # not K4's class: column, as with the switch off
            return "column"
        try:
            self.tiled_plans = [self._plan_tiled(n) for n in range(len(loops))]
            return "tiled"
        except CudaUnsupported as exc:
            reasons.append(f"tiled: {exc}")
        raise CudaUnsupported("; ".join(reasons))

    def _check_plane_class(self) -> None:
        """K1's class beyond the loop orders: 3-D fields without data
        dimensions, no tables, temporaries inside one loop, and what
        :meth:`_check_plane` admits in every loop."""
        for p in self.stencil.params:
            if isinstance(p, gtir.GlobalTableDecl):
                raise CudaUnsupported(f"GlobalTable '{p.name}'")
            if isinstance(p, gtir.FieldDecl) and (
                tuple(p.dimensions) != (True, True, True) or p.data_dims
            ):
                raise CudaUnsupported(
                    f"field '{p.name}' is lower-dimensional or has data dimensions"
                )
        owner: dict[str, int] = {}
        for n, vloop in enumerate(self.stencil.vertical_loops):
            writes, reads = _loop_symbols(vloop)
            for a in writes + reads:
                if self.fields[a.name].is_temp and owner.setdefault(a.name, n) != n:
                    raise CudaUnsupported(f"temporary '{a.name}' crosses vertical loops")
            self._check_plane(vloop)
            temps = {a.name: self.fields[a.name] for a in writes + reads}
            shared_bytes = sum(
                (PL_TI + m.extent.i[1] - m.extent.i[0]) * (PL_TJ + m.extent.j[1] - m.extent.j[0])
                * m.dtype.itemsize
                for m in temps.values()
                if m.is_temp
            )
            if shared_bytes > SHARED_BYTES_MAX:
                raise CudaUnsupported(
                    f"temporaries need {shared_bytes} bytes of shared memory per block"
                )

    # -- emission helpers ----------------------------------------------------

    def emit(self, line: str = "") -> None:
        self.lines.append("    " * self.indent + line if line else "")

    def _block(self, head: str):
        gen = self

        class _Scope:
            def __enter__(self):
                gen.emit(f"{head} {{" if head else "{")
                gen.indent += 1

            def __exit__(self, *exc):
                gen.indent -= 1
                gen.emit("}")

        return _Scope()

    # -- top level -----------------------------------------------------------

    def generate(self) -> KernelModule:
        nf = max(len(self.slots), 1)
        ns = max(self.n_shape_slots, 1)
        n_f = max(sum(1 for s in self.scalars if s[1] == "f"), 1)
        n_i = max(sum(1 for s in self.scalars if s[1] == "i"), 1)
        head = [
            f"/* generated by gt4py_tpu_torch cuda:hopper backend ({self.strategy} kernel) */",
            _PRELUDE,
            "struct GtParams {",
            f"    char* f[{nf}];",
            f"    long long sh[{ns}];",
            f"    long long st[{ns}];",
            f"    long long o[{3 * nf}];",
            f"    double fs[{n_f}];",
            f"    long long is[{n_i}];",
            "    long long ni, nj, nk;",
            "};",
            "",
            "static void gt_fill(GtParams& p, void* const* fields, const long long* shapes,",
            "                    const long long* strides, const long long* origins,",
            "                    const double* fscalars, const long long* iscalars,",
            "                    long long ni, long long nj, long long nk) {",
            f"    for (int n = 0; n < {nf}; ++n) p.f[n] = (char*)fields[n];",
            f"    for (int n = 0; n < {ns}; ++n) {{ p.sh[n] = shapes[n]; p.st[n] = strides[n]; }}",
            f"    for (int n = 0; n < {3 * nf}; ++n) p.o[n] = origins[n];",
            f"    for (int n = 0; n < {n_f}; ++n) p.fs[n] = fscalars[n];",
            f"    for (int n = 0; n < {n_i}; ++n) p.is[n] = iscalars[n];",
            "    p.ni = ni; p.nj = nj; p.nk = nk;",
            "}",
            "",
        ]
        self.lines = []
        launchers = []
        if self.strategy == "fused_plane":
            self._emit_fused_plane_kernel()
            launchers.append("gt_launch_0")
        elif self.strategy == "fused_column":
            self._emit_fused_column_kernel()
            launchers.append("gt_launch_0")
        else:  # one launcher per vertical loop
            for n, vloop in enumerate(self.stencil.vertical_loops):
                if self.strategy == "plane":
                    self._emit_plane_kernel(n, vloop)
                elif self.strategy == "column":
                    if n in self.pairs:
                        self._emit_on_chip_kernel(n)
                    self._emit_column_kernel(n, vloop)
                else:
                    self._emit_tiled_kernel(n, vloop)
                launchers.append(f"gt_launch_{n}")
                self.emit()
        staged = frozenset(
            b.meta.name for b in self.fused_plan or () if b.kind in ("staged", "table")
        )
        if self.cooperative:
            head.insert(2, _FLAG_PRELUDE)
        if self.patch_plans:
            halves = {_np_dtype(m.dtype) for m in self.slots} & set(_PACK_PRELUDE)
            head.insert(2, "".join(_PACK_PRELUDE[h] for h in sorted(halves, key=str))
                        + (_RING16_PRELUDE if self.ring_bytes else ""))
        if self.ring_bytes:
            head.insert(2, _RING_PRELUDE)
        # NOTE: name-free source: the library cache is keyed by its hash, so
        # identical definitions under different names share one build.
        return KernelModule(
            strategy=self.strategy,
            source="\n".join(head + self.lines) + "\n",
            slots=self.slots,
            scalars=self.scalars,
            n_shape_slots=self.n_shape_slots,
            launchers=launchers,
            written=frozenset(self.analyzed.written_fields()),
            nonlocal_reads=_nonlocal_reads(self.analyzed, self.strategy, staged),
            unit_axes=self._unit_axes(),
            min_nk=self.min_nk,
            cooperative=frozenset(f"gt_launch_{n}" for n in self.cooperative),
            ring_bytes=dict(self.ring_bytes),
            tile=(TL_TI, TL_TJ),
            snapshots={f"gt_launch_{n}": tuple(sorted(v)) for n, v in self.snapshots.items()},
            offset_span=self.offset_span,
            on_chip={f"gt_launch_{n}": oc for n, oc in self.on_chip.items()},
            patches={
                f"gt_launch_{n}": PatchLayout(
                    plan.width, tuple((m.name, m.dtype.itemsize) for m in plan.fields)
                )
                for n, plan in enumerate(self.patch_plans)
            },
        )

    def _unit_axes(self) -> dict[str, str]:
        """Lower-dimensional written fields: the domain axes they lack must
        have size 1 (K too in fused_plane, K2's rule, pallas_codegen.py
        :1450-1461; the K-walking kernels store a K-less field level by
        level from one thread or block, as the plain version does)."""
        out = {}
        for name in self.analyzed.written_fields():
            m = self.fields.get(name)
            if m is None or m.is_temp:
                continue
            lacking = "".join(
                ax
                for ax, present in zip("IJK", m.axes)
                if not present and (ax != "K" or self.strategy == "fused_plane")
            )
            if lacking:
                out[name] = lacking
        return out

    def _emit_locals(self, names: set[str], *, pointers: bool = True, narrow: bool = False) -> None:
        """Kernel-local pointers (unless they are kernel parameters), byte
        strides, K sizes and origins of the launch slots the loop touches,
        and the scalars; ``narrow``: the domain's I and J sizes as ``int``
        (the plane kernel's points are 32-bit)."""
        if narrow:
            self.emit("const int ni = (int)p.ni, nj = (int)p.nj;")
            self.emit("const long long nk = p.nk;")
        else:
            self.emit("const long long ni = p.ni, nj = p.nj, nk = p.nk;")
        self.emit("(void)ni; (void)nj; (void)nk;")
        for m in self.slots:
            if m.name not in names:
                continue
            v = m.var
            if pointers:
                self.emit(f"char* {v} = p.f[{m.index}];")
            pos = 0
            for role, present in zip("ijk", m.axes):
                if not present:
                    continue
                self.emit(f"const long long {v}_s{role} = p.st[{m.shape_off + pos}];")
                if role == "k":
                    self.emit(f"const long long {v}_nk = p.sh[{m.shape_off + pos}];")
                self.emit(f"const long long {v}_o{role} = p.o[{m.index * 3 + 'ijk'.index(role)}];")
                pos += 1
            for d in range(len(m.data_dims)):
                self.emit(f"const long long {v}_d{d} = p.st[{m.shape_off + pos + d}];")
        for name, kind, slot, dt in self.scalars:
            ct = _ctype(dt)
            src = f"p.fs[{slot}]" if kind == "f" else f"p.is[{slot}]"
            self.emit(f"const {ct} sc_{name} = ({ct}){src}; (void)sc_{name};")

    def _emit_launcher(
        self, n: int, kernel: str, grid: str, block: str, noalias_call: str = "",
        smem: int = 0, cooperative: bool = False, noalias_smem: int = 0, on_chip: bool = False,
    ) -> None:
        """``noalias`` (set by the wrapper when no two field buffers
        overlap) selects ``noalias_call``, the ``__restrict__`` variant
        ``<kernel>_r``, which takes ``noalias_smem`` bytes of dynamic shared
        memory. ``smem`` bytes of dynamic shared memory; above 48 KB the
        kernel is first allowed them with ``cudaFuncSetAttribute``.
        ``cooperative``: one ``cudaLaunchCooperativeKernel`` of as many
        blocks as are resident at once, at most one per tile of ``grid``,
        after zeroing the tiles' level counters ``flags``. ``on_chip``: first
        the branch of :meth:`_emit_on_chip_launch`."""
        self.emit(
            f'extern "C" int gt_launch_{n}(void* const* fields, const long long* shapes,'
        )
        self.emit("    const long long* strides, const long long* origins,")
        self.emit("    const double* fscalars, const long long* iscalars,")
        self.emit(
            "    long long ni, long long nj, long long nk, void* stream, int noalias"
            + (", int* flags) {" if cooperative else ") {")
        )
        self.indent += 1
        self.emit("GtParams p;")
        self.emit("gt_fill(p, fields, shapes, strides, origins, fscalars, iscalars, ni, nj, nk);")
        if on_chip:
            self._emit_on_chip_launch(n)
        self.emit(f"const dim3 grid({grid});")
        self.emit(f"const dim3 block({block});")
        self.emit(
            f"if (grid.x == 0 || grid.y == 0 || grid.z == 0) return {NOTHING_LAUNCHED};"
        )
        if smem > SHARED_BYTES_MAX:
            self._emit_smem_allowance(kernel, smem)
        if cooperative:
            self.emit("(void)noalias;")
            self.emit("int gt_dev = 0, gt_sms = 0, gt_per_sm = 0;")
            self.emit("cudaError_t gt_c = cudaGetDevice(&gt_dev);")
            self.emit(
                "if (gt_c == cudaSuccess) gt_c = cudaDeviceGetAttribute(&gt_sms, "
                "cudaDevAttrMultiProcessorCount, gt_dev);"
            )
            self.emit(
                "if (gt_c == cudaSuccess) gt_c = cudaOccupancyMaxActiveBlocksPerMultiprocessor("
                f"&gt_per_sm, {kernel}, (int)block.x, {smem});"
            )
            self.emit("if (gt_c != cudaSuccess) return (int)gt_c;")
            self.emit("const long long gt_tiles = (long long)grid.x * grid.y;")
            self.emit("const long long gt_fit = (long long)gt_per_sm * gt_sms;")
            self.emit("const long long gt_blocks = gt_tiles < gt_fit ? gt_tiles : gt_fit;")
            self.emit("if (gt_blocks == 0) return (int)cudaErrorCooperativeLaunchTooLarge;")
            self.emit(
                "gt_c = cudaMemsetAsync(flags, 0, gt_tiles * sizeof(int), (cudaStream_t)stream);"
            )
            self.emit("if (gt_c != cudaSuccess) return (int)gt_c;")
            self.emit("void* gt_args[] = {(void*)&p, (void*)&flags};")
            self.emit(
                f"return (int)cudaLaunchCooperativeKernel((const void*){kernel}, "
                f"dim3((unsigned)gt_blocks), block, gt_args, {smem}, (cudaStream_t)stream);"
            )
            self.indent -= 1
            self.emit("}")
            return
        if noalias_call:
            if noalias_smem > SHARED_BYTES_MAX:
                with self._block("if (noalias)"):
                    self._emit_smem_allowance(f"{kernel}_r", noalias_smem)
                    self.emit(f"{noalias_call};")
            else:
                self.emit(f"if (noalias) {noalias_call};")
            self.emit(f"else {kernel}<<<grid, block, {smem}, (cudaStream_t)stream>>>(p);")
        else:
            self.emit("(void)noalias;")
            self.emit(f"{kernel}<<<grid, block, {smem}, (cudaStream_t)stream>>>(p);")
        self.emit("return (int)cudaGetLastError();")
        self.indent -= 1
        self.emit("}")

    def _restrict_args(self, names: set[str], written: set[str]) -> tuple[str, str]:
        """A ``__restrict__`` variant's pointer parameters for the launch
        slots of ``names`` (read-only ones ``const``), and the launcher's
        arguments for them."""
        used = [m for m in self.slots if m.name in names]
        const = {m.name: "" if m.name in written else "const " for m in used}
        return (
            ", ".join(f"{const[m.name]}char* __restrict__ {m.var}" for m in used),
            ", ".join(f"({const[m.name]}char*)fields[{m.index}]" for m in used),
        )

    def _emit_smem_allowance(self, kernel: str, smem) -> None:
        """Allow ``kernel`` more than 48 KB of dynamic shared memory."""
        self.emit(
            f"const cudaError_t gt_e = cudaFuncSetAttribute({kernel}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});"
        )
        self.emit("if (gt_e != cudaSuccess) return (int)gt_e;")

    @staticmethod
    def _k_bound(b: gtir.AxisBound) -> str:
        if b.level == gtir.LevelMarker.START:
            return f"({b.offset})"
        return f"(nk + ({b.offset}))"

    def _extent_cond(self, ext: Extent, union: Optional[Extent] = None) -> str:
        """Point (i, j) inside the statement extent (terms the launch's
        thread range already guarantees are dropped)."""
        terms = []
        for var, (lo, hi), size, ulo_hi in (
            ("i", ext.i, "ni", union.i if union else None),
            ("j", ext.j, "nj", union.j if union else None),
        ):
            if ulo_hi is None or lo != ulo_hi[0]:
                terms.append(f"{var} >= ({lo})")
            if ulo_hi is None or hi != ulo_hi[1]:
                terms.append(f"{var} < {size} + ({hi})")
        return " && ".join(terms) if terms else "1"

    # -- the plane kernel ------------------------------------------------------

    def _check_plane(self, vloop: gtir.VerticalLoop) -> None:
        writes, _ = _loop_symbols(vloop)
        written = {w.name for w in writes}
        for w in writes:
            m = self.fields[w.name]
            if w.offset != (0, 0, 0) or w.koffset is not None:
                raise CudaUnsupported(f"offset write to '{w.name}' in a PARALLEL loop")
            if not m.is_temp and not m.axes[2]:
                raise CudaUnsupported(
                    f"PARALLEL write to '{w.name}', which has no K axis"
                )
        for section in vloop.sections:
            for stmt in section.body:
                ext = self.analyzed.stmt_extents[stmt]
                wide = ext.i != (0, 0) or ext.j != (0, 0)
                targets = {w.name for w in iter_writes(stmt)}
                for t in targets:
                    if not self.fields[t].is_temp and wide:
                        raise CudaUnsupported(
                            f"API field '{t}' is read at a horizontal offset after "
                            "it is written; a later kernel serves it"
                        )
                for r in _iter_reads(stmt):
                    shifted = r.offset[0] != 0 or r.offset[1] != 0
                    if r.name in written and not self.fields[r.name].is_temp and (
                        shifted or wide
                    ):
                        raise CudaUnsupported(
                            f"API field '{r.name}' is written and read at a horizontal "
                            "offset in one PARALLEL loop; a later kernel serves it"
                        )
                    if r.name in targets and shifted:
                        raise CudaUnsupported(
                            f"statement reads its own target '{r.name}' at an offset"
                        )

    def _plan_plane(self, n: int) -> list[_Buffer]:
        """K1's class, loop ``n``, plain-pointer variant: each temporary a
        shared plane over its footprint, zero-filled at the levels of each
        section whose first access to it is not an unconditional write of
        the whole plane (the plain version's zero-filled temporary: a level
        the section does not set reads 0)."""
        items = self._items([n])
        buffers = []
        for m in self.fields.values():
            if not m.is_temp or not any(a.name == m.name for it in items for a in it.reads + it.writes):
                continue
            b = self._shared_buffer(items, m.name, (PL_TI, PL_TJ))
            init = set()
            for sid in sorted({it.section for it in items}):
                sec = [it for it in items if it.section == sid]
                if any(a.name == m.name for it in sec for a in it.reads + it.writes) and not (
                    self._first_access_covers(sec, m.name, b.fp)
                ):
                    init.add(sid)
            b.init = frozenset(init)
            buffers.append(b)
        self.plane_bytes[n] = self._layout(buffers, "plane")
        return buffers

    def _plan_patch(self, n: int) -> _PatchPlan:
        """K1's class, loop ``n``, ``_r`` variant (register patches). A
        patch is ``PL_PATCH_WIDTH`` J points (a vector of the storage) by
        ``PL_PATCH_ROWS`` rows, at most 16 bytes of the loop's widest API
        field with a vector path (float16 and bfloat16, and 4- and 8-byte
        types: :data:`_VECTORS`); one point where it has none. Each
        statement runs over its extent rounded out to whole patches, so a
        patch reads beyond the footprint by up to a patch less one point:
        the temporaries' planes and the input ring's span that too. The ring
        is :meth:`_plan_tile_ring`'s, half fields included (they move as
        vectors), each plane copied over its footprint rounded out to whole
        vectors."""
        items = self._items([n])
        names = {a.name for it in items for a in it.reads + it.writes}
        api = [m for m in self.slots if m.name in names]
        vector = [m for m in api if _chunks(_raw(m.dtype), m.dtype.itemsize, 2)[0]]
        widest = max((m.dtype.itemsize for m in vector), default=16)
        width = min(PL_PATCH_WIDTH, 16 // widest)
        rows = max(1, min(PL_PATCH_ROWS, 16 // (width * widest)))
        fields = [
            m for m in vector if _chunks(_raw(m.dtype), m.dtype.itemsize, width)[0]
        ][:PATCH_MASK_FIELDS]
        regions = {}
        for it in items:
            e = it.ext
            regions[id(it.stmt)] = (
                e.i[0], e.i[0] + -(-(PL_TI + e.i[1] - e.i[0]) // rows) * rows,
                e.j[0] // width * width, -(-(PL_TJ + e.j[1]) // width) * width,
            )

        def span(boxes) -> Extent:
            """The tile-relative extent of a plane over these boxes, its
            columns rounded out to whole vectors."""
            r0, r1 = min(b[0] for b in boxes), max(b[1] for b in boxes)
            c0, c1 = min(b[2] for b in boxes), max(b[3] for b in boxes)
            return Extent(
                i=(r0, r1 - PL_TI),
                j=(c0 // width * width, -(-c1 // width) * width - PL_TJ),
            )

        def touched(name: str, served=None) -> list:
            """The boxes of ``name``'s plane the patches write and read
            (``served``: the reads the ring serves, per statement)."""
            boxes = []
            for it in items:
                r0, r1, c0, c1 = regions[id(it.stmt)]
                if served is None and it.writes_name(name):
                    boxes.append((r0, r1, c0, c1))
                offsets = (
                    [r.offset for r in it.reads if r.name == name] if served is None
                    else [off for _, off in served.get(id(it.stmt), ())]
                )
                boxes += [(r0 + di, r1 + di, c0 + dj, c1 + dj) for di, dj, _ in offsets]
            return boxes

        def sized(b: _Buffer) -> _Buffer:
            b.rows = PL_TI + b.fp.i[1] - b.fp.i[0]
            b.cols = PL_TJ + b.fp.j[1] - b.fp.j[0]
            return b

        planes = [
            sized(dataclasses.replace(b, fp=span(touched(b.meta.name))))
            for b in self.plane_plans[n]
        ]
        base = self._layout(planes, "plane")
        ring = self._plan_tile_ring(
            items, planes, (PL_TI, PL_TJ), PL_THREADS, base, fused=True,
            levels=PL_RING_LEVELS, half=True,
        )
        for b in ring:
            b.fill = b.fp
            fill = (b.fp.i[0], PL_TI + b.fp.i[1], b.fp.j[0], PL_TJ + b.fp.j[1])
            b.fp = span([fill] + touched(b.meta.name, b.serves))
            sized(b)
        while ring and base + sum(b.bytes for b in ring) > SHARED_BYTES_LIMIT:
            ring.pop()  # the widened planes outgrew the card: load the last directly
        offset = base
        for b in ring:
            b.offset = offset
            offset += b.bytes
        self.tile_rings[n] = ring
        return _PatchPlan(
            width=width, rows=rows, regions=regions, planes=planes, ring=ring,
            fields=fields, bytes=offset,
        )

    @staticmethod
    def _plane_block() -> tuple[int, int]:
        """A plane block's threads: a row of ``PL_TJ`` along J (whole warps,
        on the tile's columns) and as many rows of I as make ``PL_THREADS``;
        a statement or ring plane wider than the tile takes its columns
        beyond in further passes (:func:`_column_passes`)."""
        return PL_TJ, max(1, PL_THREADS // PL_TJ)

    def _emit_plane_kernel(self, n: int, vloop: gtir.VerticalLoop) -> None:
        """Two variants of one skeleton: ``gt_plane_<n>`` with plain
        pointers, for any arguments, one point a thread, and
        ``gt_plane_<n>_r`` (:meth:`_emit_patch_variant`), register patches,
        taking the fields as ``__restrict__`` parameters (read-only ones
        ``const``) and prefetching its input planes through the tile ring,
        for arguments whose buffers do not overlap. Both walk ``PL_TK``
        levels of one tile a block. The launcher's ``noalias`` word
        (:meth:`PatchLayout.word`) also carries the ``_r`` kernel's shift of
        the tiles along J and the fields that take their vector path."""
        items = self._items([n])
        names = {a.name for it in items for a in it.reads + it.writes}
        written = {w.name for it in items for w in it.writes}
        patch = self.patch_plans[n]
        block = self._plane_block()
        kernel = f"gt_plane_{n}"
        params, args = self._restrict_args(names, written)
        self._emit_plane_variant(kernel, items, self.plane_plans[n], block)
        self.noalias, self.read_only = True, names - written
        self._emit_patch_variant(kernel + "_r", items, patch, params)
        self.noalias, self.read_only = False, set()
        smem = self.plane_bytes[n]
        if patch.ring:
            self.ring_bytes[kernel + "_r"] = sum(b.bytes for b in patch.ring)
        reach = [(it.ext.i, it.ext.j) for it in items] + [
            (b.fp.i, b.fp.j) for b in patch.planes + patch.ring
        ] + [((r0, r1 - PL_TI), (c0, c1 - PL_TJ)) for r0, r1, c0, c1 in patch.regions.values()]
        self.offset_span = (
            max([self.offset_span[0]] + [max(-i[0], PL_TI + i[1]) for i, _ in reach]),
            max([self.offset_span[1]] + [max(-j[0], PL_TJ + j[1]) for _, j in reach]),
        )
        shift = f"(noalias >> 1) & {(1 << PATCH_SHIFT_BITS) - 1}"
        self._emit_launcher(
            n,
            kernel,
            f"(unsigned)((nj + {PL_TJ - 1}) / {PL_TJ}), (unsigned)((ni + {PL_TI - 1}) / {PL_TI}), "
            f"(unsigned)((nk + {PL_TK - 1}) / {PL_TK})",
            f"{block[0]}, {block[1]}",
            smem=smem,
            noalias_call=(
                f"{kernel}_r<<<dim3((unsigned)((nj + ({shift}) + {PL_TJ - 1}) / {PL_TJ}), "
                f"grid.y, grid.z), dim3({PL_THREADS}), {patch.bytes}, (cudaStream_t)stream>>>"
                f"(p{', ' if args else ''}{args}, {shift}, (unsigned)noalias >> {PATCH_MASK_AT})"
            ),
            noalias_smem=patch.bytes,
        )

    def _emit_plane_variant(
        self, kernel: str, items: list[_Item], plan: list[_Buffer], block: tuple[int, int],
    ) -> None:
        """``gt_plane_<n>``, for arguments that may overlap. One block: its
        tile's corner (i0, j0) and each field's address there, computed once
        in 64 bits; per level each field's address at the level; per point a
        32-bit offset from it. Statements in program order over the tile
        widened by their extents, with barriers where :meth:`_hazard` places
        them and one that turns each level over where the block shares a
        plane."""
        bj, bi = block
        names = {a.name for it in items for a in it.reads + it.writes}
        fields = [m for m in self.slots if m.name in names]
        self.buffers = {b.meta.name: b for b in plan}
        self.emit(f"__global__ void __launch_bounds__({bj * bi}) {kernel}(const GtParams p) {{")
        self.indent += 1
        self._emit_locals(names, narrow=True)
        self.emit(f"const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * {bj} + tx;")
        self.emit(f"const int i0 = blockIdx.y * {PL_TI}, j0 = blockIdx.x * {PL_TJ};")
        self.emit(f"const long long kb0 = (long long)blockIdx.z * {PL_TK};")
        self.emit(f"const long long kb1 = kb0 + {PL_TK} < nk ? kb0 + {PL_TK} : nk;")
        for m in fields:
            v = m.var
            self.emit(f"char* const {v}_t = {v} + ({v}_oi + i0) * {v}_si + ({v}_oj + j0) * {v}_sj;")
            self.emit(f"const int {v}_si4 = (int){v}_si, {v}_sj4 = (int){v}_sj;")
        self._emit_buffer_pointers(plan)
        with self._block("for (long long k = kb0; k < kb1; ++k)"):
            if plan:
                self.emit("__syncthreads();")  # no thread still reads the planes
            for m in fields:
                self.emit(f"char* const {m.var}_k = {m.var}_t + ({m.var}_ok + k) * {m.var}_sk;")
            since: list = []
            for sid in sorted({it.section for it in items}):
                sec = [it for it in items if it.section == sid]
                lo, hi = self._k_bound(sec[0].interval.start), self._k_bound(sec[0].interval.end)
                with self._block(f"if (k >= {lo} && k < {hi})"):
                    fills = [b for b in plan if sid in b.init]
                    for b in fills:
                        ct = _ctype(b.meta.dtype)
                        with self._block(f"for (int q = tid; q < {b.plane}; q += {bj * bi})"):
                            self.emit(f"{b.meta.var}_s[q] = ({ct})0;")
                    if fills:
                        self.emit("__syncthreads();")
                    self._emit_statements(sec, None, bj * bi, [] if fills else since, plane=block)
                # a barrier inside the section may not run: the section's
                # statements stay pending for the next
                since += sec
        self.indent -= 1
        self.emit("}")
        self.emit()
        self.buffers = {}

    def _emit_plane_item(self, it: _Item, block: tuple[int, int]) -> None:
        """One statement over the tile widened by its extent: thread (tx,
        ty) takes column tx of the widened tile (and tx + PL_TJ, ... in
        further passes) and walks its rows ty, ty + rows of threads, ...; a
        field's address at the point is its level's address plus a 32-bit
        offset, a shared plane's element a 32-bit index."""
        bj, bi = block
        ext = it.ext
        rows, cols = PL_TI + ext.i[1] - ext.i[0], PL_TJ + ext.j[1] - ext.j[0]
        for c0, cond in _column_passes(cols, bj):
            with self._block(cond):
                self._emit_plane_point(it, f"tx + ({c0 + ext.j[0]})", rows, bi)

    def _emit_plane_point(self, it: _Item, dj: str, rows: int, bi: int) -> None:
        """:meth:`_emit_plane_item`'s rows of one column pass: ``dj`` the
        thread's column from the tile's corner."""
        ext = it.ext
        self.emit(f"const int gt_dj = {dj}, j = j0 + gt_dj;")
        with self._block(f"for (int gt_r = ty; gt_r < {rows}; gt_r += {bi})"):
            self.emit(f"const int gt_di = gt_r + ({ext.i[0]}), i = i0 + gt_di;")
            with self._block(f"if ({self._extent_cond(ext)})"):
                self.point_base = {}
                for name in sorted({a.name for a in it.reads + it.writes}):
                    m = self._meta(name)
                    b = self.buffers.get(name)
                    if b is not None:
                        self.emit(
                            f"const int {m.var}_x = (gt_di - ({b.fp.i[0]})) * {b.cols}"
                            f" + (gt_dj - ({b.fp.j[0]}));"
                        )
                    if not m.is_temp:
                        self.emit(
                            f"char* const {m.var}_b = {m.var}_k + "
                            f"(gt_di * {m.var}_si4 + gt_dj * {m.var}_sj4);"
                        )
                        self.point_base[name] = f"{m.var}_b"
                self.item = it
                self._emit_stmt(it.stmt)
                self.item = None

    # -- the plane kernel's register patches (``_r``) --------------------------

    def _emit_patch_variant(
        self, kernel: str, items: list[_Item], plan: _PatchPlan, params: str
    ) -> None:
        """``gt_plane_<n>_r``: a block of ``PL_THREADS`` walks ``PL_TK``
        levels of a PL_TI × PL_TJ tile whose columns start on whole vectors
        of the storage: tile ``x`` starts ``gt_s`` columns before column
        ``x * PL_TJ`` of the domain (the launcher's shift), so the tiles at
        the domain's two edges overhang it. ``gt_vec`` says which fields
        lie on those vectors too (bit ``b``: ``plan.fields[b]``); the
        others move element by element (never a half field: such a launch
        runs ``gt_plane_<n>``, :meth:`PatchLayout.word`). Each statement runs over patches
        (:meth:`_emit_patch_item`); ``gt_inner``: the tile's patches read
        and write no point beyond the fields' valid points, so they store
        whole vectors and load direct ones unguarded."""
        names = {a.name for it in items for a in it.reads + it.writes}
        fields = [m for m in self.slots if m.name in names]
        self.buffers = {b.meta.name: b for b in plan.planes + plan.ring}
        self.emit(
            f"__global__ void __launch_bounds__({PL_THREADS}, {PL_PATCH_BLOCKS}) {kernel}("
            f"const GtParams p, {params}{', ' if params else ''}const int gt_s, const unsigned gt_vec) {{"
        )
        self.indent += 1
        self._emit_locals(names, pointers=not params, narrow=True)
        self.emit("const int tid = threadIdx.x;")
        self.emit(f"const int i0 = blockIdx.y * {PL_TI}, j0 = blockIdx.x * {PL_TJ} - gt_s;")
        self.emit(f"const long long kb0 = (long long)blockIdx.z * {PL_TK};")
        self.emit(f"const long long kb1 = kb0 + {PL_TK} < nk ? kb0 + {PL_TK} : nk;")
        for m in fields:
            v, const = m.var, "const " if m.name in self.read_only else ""
            self.emit(f"{const}char* const {v}_t = {v} + ({v}_oi + i0) * {v}_si + ({v}_oj + j0) * {v}_sj;")
            self.emit(f"const int {v}_si4 = (int){v}_si, {v}_sj4 = (int){v}_sj;")
        for b, m in enumerate(plan.fields):
            self.emit(f"const bool {m.var}_v = (gt_vec >> {b}) & 1u;")
        self.emit(f"const bool gt_inner = {self._patch_inner(items, plan)};")
        self.emit("(void)gt_inner;")
        self._emit_buffer_pointers(plan.planes + plan.ring)
        span = self._emit_patch_ring_setup(plan) if plan.ring else (0, 0)
        # the fields the patches store or load from device memory
        direct = {w.name for it in items for w in it.writes} | {
            r.name for it in items for r in it.reads if r.name not in self.buffers or (
                self.buffers[r.name].kind == "input"
                and (r.name, r.offset) not in self.buffers[r.name].serves.get(id(it.stmt), ())
            )
        }
        with self._block("for (long long k = kb0; k < kb1; ++k)"):
            if plan.planes or plan.ring:
                self._emit_level_start(plan.ring, span, "k - gt_w0")
            for b in plan.ring:
                self.emit(
                    f"const {_raw(b.meta.dtype)}* const {b.meta.var}_l = {b.meta.var}_s + "
                    f"gt_slot(k, {b.ring}) * {b.plane};"
                )
            for m in fields:
                if m.name in direct:
                    v, const = m.var, "const " if m.name in self.read_only else ""
                    self.emit(f"{const}char* const {v}_k = {v}_t + ({v}_ok + k) * {v}_sk;")
            since: list = []
            for sid in sorted({it.section for it in items}):
                sec = [it for it in items if it.section == sid]
                lo, hi = self._k_bound(sec[0].interval.start), self._k_bound(sec[0].interval.end)
                with self._block(f"if (k >= {lo} && k < {hi})"):
                    fills = [b for b in plan.planes if sid in b.init]
                    for b in fills:
                        ct = _ctype(b.meta.dtype)
                        with self._block(f"for (int q = tid; q < {b.plane}; q += {PL_THREADS})"):
                            self.emit(f"{b.meta.var}_s[q] = ({ct})0;")
                    if fills:
                        self.emit("__syncthreads();")
                    self._emit_statements(sec, None, PL_THREADS, [] if fills else since, patch=plan)
                since += sec
        if plan.ring:
            self.emit("gt_cp_wait_all();")
        self.indent -= 1
        self.emit("}")
        self.emit()
        self.buffers = {}

    def _patch_inner(self, items: list[_Item], plan: _PatchPlan) -> str:
        """The condition under which a tile's patches touch no point beyond
        the fields' valid ones: the tile lies inside the domain (API fields
        are written only by statements of zero extent, whose patches cover
        the tile), and every direct load of every patch lies inside its
        field's footprint."""
        terms = [f"i0 + {PL_TI} <= ni", "j0 >= 0", f"j0 + {PL_TJ} <= nj"]
        for m in self.slots:
            boxes = []
            for it in items:
                r0, r1, c0, c1 = plan.regions[id(it.stmt)]
                b = self.buffers.get(m.name)
                served = b.serves.get(id(it.stmt), ()) if b is not None else ()
                boxes += [
                    (r0 + r.offset[0], r1 + r.offset[0], c0 + r.offset[1], c1 + r.offset[1])
                    for r in it.reads
                    if r.name == m.name and (m.name, r.offset) not in served
                ]
            if not boxes:
                continue
            fp = self._footprint(items, m.name)
            terms += [
                f"i0 + ({min(x[0] for x in boxes)}) >= ({fp.i[0]})",
                f"i0 + ({max(x[1] for x in boxes)}) <= ni + ({fp.i[1]})",
                f"j0 + ({min(x[2] for x in boxes)}) >= ({fp.j[0]})",
                f"j0 + ({max(x[3] for x in boxes)}) <= nj + ({fp.j[1]})",
            ]
        return " && ".join(terms)

    def _vector_flag(self, m: FieldMeta, plan: _PatchPlan) -> str:
        """The block's flag: ``m`` lies on the tiles' vectors."""
        return f"{m.var}_v" if any(f.name == m.name for f in plan.fields) else "false"

    def _emit_patch_ring_setup(self, plan: _PatchPlan) -> tuple[int, int]:
        """The input ring of the ``_r`` kernel: each plane's copies over its
        footprint rounded out to whole vectors, ``n`` vectors along J by its
        rows, spread over the block's threads; a thread's share is fixed, so
        each copy's offsets, and which of its elements lie inside the
        field's valid points, are worked out once a block (``<f>_o<m>``,
        ``<f>_d<m>``, ``<f>_f<m>``: bit ``w`` a whole vector of a field on
        the tiles' vectors, else a bit a valid element). At a level a whole
        vector is one ``cp.async``; the rest (a field off them, or a vector
        cut by the edge of the valid points) copy their valid elements one
        by one (a half element with a plain load and store: ``cp.async``
        copies no 2 bytes). Returns (how far ahead the reads reach, the
        depth), as :meth:`_emit_tile_ring_setup`."""
        ring, w, T = plan.ring, plan.width, PL_THREADS
        back, ahead = self._ring_span(ring, False)
        depth = ring[0].ring - back
        self.emit("const unsigned gt_sm = (unsigned)__cvta_generic_to_shared(gt_smem);")
        self.emit("const long long gt_w0 = kb0, gt_wn = kb1 - kb0;")
        copies = []  # (buffer, its copies: rows, vectors a row, first row, first column)
        for b in ring:
            f = b.fill
            c0, c1 = f.j[0] // w * w, -(-(PL_TJ + f.j[1]) // w) * w
            r0, r1 = f.i[0], PL_TI + f.i[1]
            copies.append((b, r1 - r0, (c1 - c0) // w, r0, c0))
        for b, nr, nv, r0, c0 in copies:
            v, size = b.meta.var, b.meta.dtype.itemsize
            f = b.fill
            for q in range(-(-nr * nv // T)):
                self.emit(f"int {v}_o{q}; unsigned {v}_d{q}, {v}_f{q};")
                with self._block(""):
                    self.emit(f"const int gt_q = tid + {q * T};")
                    self.emit(f"const int gt_r = gt_q / {nv} + ({r0}), gt_c = gt_q % {nv} * {w} + ({c0});")
                    self.emit(f"{v}_o{q} = gt_r * {v}_si4 + gt_c * {v}_sj4;")
                    self.emit(
                        f"{v}_d{q} = (unsigned)(((gt_r - ({b.fp.i[0]})) * {b.cols} + "
                        f"(gt_c - ({b.fp.j[0]}))) * {size});"
                    )
                    self.emit(
                        f"const bool gt_row = gt_q < {nr * nv} && i0 + gt_r >= ({f.i[0]}) && "
                        f"i0 + gt_r < ni + ({f.i[1]});"
                    )
                    self.emit(f"const int gt_lo = max(0, ({f.j[0]}) - (j0 + gt_c));")
                    self.emit(f"const int gt_hi = gt_row ? min({w}, nj + ({f.j[1]}) - (j0 + gt_c)) : 0;")
                    self.emit(f"const unsigned gt_e = gt_hi > gt_lo ? (1u << gt_hi) - (1u << gt_lo) : 0u;")
                    self.emit(
                        f"{v}_f{q} = {self._vector_flag(b.meta, plan)} && gt_e == {(1 << w) - 1}u "
                        f"? {1 << w}u : gt_e;"
                    )
        self.emit("auto gt_tfetch = [&](const int gt_f) {")
        self.indent += 1
        with self._block(f"if (gt_f < gt_wn + {ahead})"):
            self.emit("const long long gt_k = gt_w0 + gt_f;")
            for b, nr, nv, r0, c0 in copies:
                v, size = b.meta.var, b.meta.dtype.itemsize
                with self._block(""):
                    self.emit(
                        f"const unsigned gt_d = gt_sm + {b.offset}u + "
                        f"(unsigned)gt_slot(gt_k, {b.ring}) * {b.plane * size}u;"
                    )
                    self.emit(f"const char* const gt_g = {v}_t + gt_clampk({v}_ok + gt_k, {v}_nk) * {v}_sk;")
                    for q in range(-(-nr * nv // T)):
                        self.emit(
                            f"if ({v}_f{q} == {1 << w}u) "
                            f"gt_cp_async{w * size}(gt_d + {v}_d{q}, gt_g + {v}_o{q});"
                        )
                        with self._block("else"):
                            self._emit_patch_copy_elements(b, q, w)
        self.emit("gt_cp_commit();")
        self.indent -= 1
        self.emit("};")
        self.emit(f"for (int gt_f = {-back}; gt_f < {depth - 1}; ++gt_f) gt_tfetch(gt_f);")
        return ahead, depth

    def _emit_patch_copy_elements(self, b: _Buffer, q: int, w: int) -> None:
        """Copy ``b``'s vector ``q`` of the thread element by element: those
        of its elements whose bit ``<f>_f<q>`` sets, each element's copy
        under its own predicate, so that a thread's copies are in flight
        together (a 16-bit one through the thread's registers: every load,
        then every store)."""
        v, size, raw = b.meta.var, b.meta.dtype.itemsize, _raw(b.meta.dtype)
        for e in range(w):
            src = f"gt_g + {v}_o{q} + {e} * {v}_sj4"
            if size in (4, 8):
                self.emit(
                    f"if ({v}_f{q} & {1 << e}u) "
                    f"gt_cp_async{size}(gt_d + {v}_d{q} + {e * size}u, {src});"
                )
            else:
                self.emit(f"const {raw} gt_x{e} = {v}_f{q} & {1 << e}u ? *(const {raw}*)({src}) : 0;")
        if size not in (4, 8):
            base = f"(gt_d - gt_sm - {b.offset}u + {v}_d{q}) / {size}u"
            for e in range(w):
                self.emit(f"if ({v}_f{q} & {1 << e}u) {v}_s[{base} + {e}] = gt_x{e};")

    @staticmethod
    def _valid_cond(fp: Extent, i: str, j: str) -> str:
        """The point (``i``, ``j``) lies inside the valid points of a
        footprint ``fp`` (from the domain's origin)."""
        return (
            f"{i} >= ({fp.i[0]}) && {i} < ni + ({fp.i[1]}) && "
            f"{j} >= ({fp.j[0]}) && {j} < nj + ({fp.j[1]})"
        )

    @staticmethod
    def _reg(v: str, src: str, row: int, col: int) -> str:
        """The register of a patch's element (row, col from its corner) of
        field ``v``, read from shared memory (``src`` "s") or device memory
        ("g")."""
        def n(x: int) -> str:
            return f"m{-x}" if x < 0 else str(x)

        return f"{v}_{src}{n(row)}_{n(col)}"

    def _patch_source(self, it: _Item, node: gtir.FieldAccess) -> str:
        """Where statement ``it`` reads ``node``: "s" a shared plane (a
        temporary, or a ring read the ring serves), "g" device memory."""
        b = self.buffers.get(node.name)
        if b is not None and (b.kind == "shared" or (node.name, node.offset) in self.ring_reads):
            return "s"
        return "g"

    def _emit_patch_item(self, it: _Item, plan: _PatchPlan) -> None:
        """One statement over its patches: thread ``tid`` takes patches
        ``tid``, ``tid + PL_THREADS``, ... of the statement's region (row
        groups by columns of whole vectors), each at (``gt_r``, ``gt_c``)
        from the tile's corner. A ``while`` runs point by point within the
        patch, as the plain-pointer variant runs it; any other statement
        loads every element its reads touch once into registers
        (:meth:`_emit_patch_loads`), evaluates its expression at each point
        from them, and stores the patch (:meth:`_emit_patch_stores`)."""
        w, rows = plan.width, plan.rows
        r0, r1, c0, c1 = plan.regions[id(it.stmt)]
        nr, nc = (r1 - r0) // rows, (c1 - c0) // w
        self.ring_reads = frozenset(
            read
            for b in self.buffers.values()
            if b.kind == "input"
            for read in b.serves.get(id(it.stmt), ())
        )
        with self._block(f"for (int gt_q = tid; gt_q < {nr * nc}; gt_q += {PL_THREADS})"):
            self.emit(f"const int gt_r = gt_q / {nc} * {rows} + ({r0}), gt_c = gt_q % {nc} * {w} + ({c0});")
            if isinstance(it.stmt, gtir.While):
                self._emit_patch_points(it, plan)
            else:
                names = sorted({a.name for a in it.reads + it.writes})
                for name in names:
                    m, b = self._meta(name), self.buffers.get(name)
                    if b is not None:
                        self.emit(
                            f"const int {m.var}_x = (gt_r - ({b.fp.i[0]})) * {b.cols}"
                            f" + (gt_c - ({b.fp.j[0]}));"
                        )
                    if not m.is_temp and (
                        it.writes_name(name)
                        or any(r.name == name and self._patch_source(it, r) == "g" for r in it.reads)
                    ):
                        const = "const " if name in self.read_only else ""
                        self.emit(
                            f"{const}char* const {m.var}_b = {m.var}_k + "
                            f"(gt_r * {m.var}_si4 + gt_c * {m.var}_sj4);"
                        )
                self._emit_patch_loads(it, plan)
                self._emit_patch_values(it, plan)
                self._emit_patch_stores(it, plan)
        self.ring_reads = frozenset()

    def _emit_patch_points(self, it: _Item, plan: _PatchPlan) -> None:
        """A statement point by point within the patch (a ``while``): each
        point of the statement's tile and extent, with the plain-pointer
        variant's addressing."""
        ext = it.ext
        names = sorted({a.name for a in it.reads + it.writes})
        for pi in range(plan.rows):
            for pj in range(plan.width):
                with self._block(""):
                    self.emit(
                        f"const int gt_di = gt_r + ({pi}), gt_dj = gt_c + ({pj}), "
                        "i = i0 + gt_di, j = j0 + gt_dj;"
                    )
                    cond = self._extent_cond(ext) + " && " + self._tile_cond(ext, "gt_di", "gt_dj")
                    with self._block(f"if ({cond})"):
                        self.point_base = {}
                        for name in names:
                            m, b = self._meta(name), self.buffers.get(name)
                            if b is not None:
                                self.emit(
                                    f"const int {m.var}_x = (gt_di - ({b.fp.i[0]})) * {b.cols}"
                                    f" + (gt_dj - ({b.fp.j[0]}));"
                                )
                            if not m.is_temp and (
                                b is None
                                or it.writes_name(name)
                                or any(
                                    r.name == name and (name, r.offset) not in self.ring_reads
                                    for r in it.reads
                                )
                            ):
                                const = "const " if name in self.read_only else ""
                                self.emit(
                                    f"{const}char* const {m.var}_b = {m.var}_k + "
                                    f"(gt_di * {m.var}_si4 + gt_dj * {m.var}_sj4);"
                                )
                                self.point_base[name] = f"{m.var}_b"
                        self.item = it
                        self._emit_stmt(it.stmt)
                        self.item = None

    @staticmethod
    def _tile_cond(ext: Extent, di: str, dj: str) -> str:
        """The point (``di``, ``dj`` from the tile's corner) lies in the
        statement's tile widened by its extent."""
        return (
            f"{di} < {PL_TI + ext.i[1]} && {dj} >= ({ext.j[0]}) && {dj} < {PL_TJ + ext.j[1]}"
        )

    def _emit_patch_loads(self, it: _Item, plan: _PatchPlan) -> None:
        """Every element the statement's reads touch at the patch's points,
        once, into registers (:meth:`_reg`), row by row of each field. From
        a shared plane: its whole vectors as vectors, the rest (a centre
        row's neighbours) element by element. From device memory likewise
        for a field on the tiles' vectors in an inner tile; else element by
        element, outside an inner tile each guarded by the field's valid
        points (0 beyond them, which no point of the statement's extent
        reads)."""
        w, rows = plan.width, plan.rows
        need: dict = {}  # (name, source) -> {row: {column}}
        for r in it.reads:
            di, dj, _ = r.offset
            cols = need.setdefault((r.name, self._patch_source(it, r)), {})
            for pi in range(rows):
                cols.setdefault(pi + di, set()).update(pj + dj for pj in range(w))
        for (name, src), by_row in sorted(need.items()):
            m, b = self._meta(name), self.buffers.get(name)
            v, ct = m.var, _ctype(m.dtype)
            if src == "s":
                base, et = (f"{v}_l", _raw(m.dtype)) if b.kind == "input" else (f"{v}_s", ct)
                for row, cols in sorted(by_row.items()):
                    self._emit_row_loads(
                        m, "s", row, cols, w, et, b.size,
                        lambda c, row=row, cols=b.cols: f"{base} + {v}_x + ({row * cols + c})",
                    )
                continue
            regs = [self._reg(v, "g", row, c) for row, cols in sorted(by_row.items()) for c in sorted(cols)]
            self.emit(f"{ct} {', '.join(regs)};")
            size = m.dtype.itemsize
            scope = self._block("")
            if _chunks(_raw(m.dtype), size, w)[0]:
                with self._block(f"if ({self._vector_flag(m, plan)} && gt_inner)"):
                    for row, cols in sorted(by_row.items()):
                        self._emit_row_loads(
                            m, "g", row, cols, w, _raw(m.dtype), size,
                            lambda c, row=row: f"{v}_b + ({row} * {v}_si4 + {c * size})",
                            declare=False,
                        )
                scope = self._block("else")
            with scope:
                self._emit_guarded_loads(it, m, by_row)

    def _emit_guarded_loads(self, it: _Item, m: FieldMeta, by_row: dict) -> None:
        """Registers (:meth:`_reg`, "g") of ``by_row`` (row -> columns from
        the patch's corner) of API field ``m``, element by element from
        device memory, each in an inner tile or where it lies inside the
        field's valid points, and 0 beyond them."""
        v, ct = m.var, _ctype(m.dtype)
        fp = self._footprint(self._items([it.loop]), m.name)
        for row, cols in sorted(by_row.items()):
            for c in sorted(cols):
                load = _load(m, f"{v}_b + ({row} * {v}_si4 + {c} * {v}_sj4)", const=m.name in self.read_only)
                cond = self._valid_cond(fp, f"i0 + gt_r + ({row})", f"j0 + gt_c + ({c})")
                self.emit(f"{self._reg(v, 'g', row, c)} = gt_inner || ({cond}) ? {load} : ({ct})0;")

    def _emit_row_loads(
        self, m: FieldMeta, src: str, row: int, cols: set, w: int, et: str, size: int, addr,
        declare: bool = True,
    ) -> None:
        """Registers of ``cols`` (columns from the patch's corner) of one
        row of ``m``, whose elements are C type ``et`` of ``size`` bytes
        there: each whole vector among them (the patch's columns, and each
        ``w`` beside them) by vector loads, the others one by one.
        ``addr(c)``: column ``c``'s address (a pointer into a shared plane,
        or a byte address in device memory)."""
        ct = _ctype(m.dtype)
        vt, per = _chunks(et, size, w)
        half = _HALF_TYPES.get(_np_dtype(m.dtype)) if et == "unsigned short" else None
        decl = f"const {ct} " if declare else ""
        whole = set()
        if vt:
            for start in range(min(cols) // w * w, max(cols) + 1, w):
                if set(range(start, start + w)) <= cols:
                    whole.update(range(start, start + w))
        for c in sorted(whole):
            if c % per:
                continue
            q = self._reg(m.var, "q" + src, row, c)
            self.emit(f"const {vt} {q} = *(const {vt}*)({addr(c)});")
            for e in range(per):
                if half:
                    word = q if vt == "unsigned" else f"{q}.{'xyzw'[e // 2]}"
                    value = f"{half[1]}({half[3]}((unsigned short)({word} >> {16 * (e % 2)})))"
                else:
                    value = f"{q}.{'xyzw'[e]}"
                self.emit(f"{decl}{self._reg(m.var, src, row, c + e)} = {value};")
        for c in sorted(cols - whole):
            if src == "g":
                value = _load(m, addr(c), const=m.name in self.read_only)
            else:
                value = f"*({addr(c)})"
                if half:
                    value = f"{half[1]}({half[3]}({value}))"
            self.emit(f"{decl}{self._reg(m.var, src, row, c)} = {value};")

    def _emit_patch_values(self, it: _Item, plan: _PatchPlan) -> None:
        """The statement's value (``gt_v<row>_<col>``) and mask
        (``gt_m<row>_<col>``) at each point of the patch, its reads the
        registers of :meth:`_emit_patch_loads`."""
        stmt = it.stmt
        ct = _ctype(self._meta(stmt.target.name).dtype)
        self.item = it
        for pi in range(plan.rows):
            for pj in range(plan.width):
                self.patch_point = (pi, pj)
                self.emit(f"const {ct} gt_v{pi}_{pj} = {self._expr(stmt.value)};")
                if stmt.mask is not None:
                    self.emit(f"const bool gt_m{pi}_{pj} = ({self._expr(stmt.mask)}) != 0;")
        self.patch_point, self.item = None, None

    def _emit_patch_stores(self, it: _Item, plan: _PatchPlan) -> None:
        """The patch's values (``gt_v<row>_<col>``) to the target. A
        temporary that this statement alone writes, unmasked and never
        zero-filled, takes whole vectors: the points it computes beyond its
        extent are points no read of the loop finds. An API field on the
        tiles' vectors takes one vector store a row in an inner tile. Any
        other store goes point by point, where the point lies in the
        statement's extent (and its tile, for a temporary), and its mask
        and regions."""
        stmt, w, rows = it.stmt, plan.width, plan.rows
        t = stmt.target
        m, b = self._meta(t.name), self.buffers.get(t.name)
        hmasks = getattr(stmt, "horizontal_masks", ())
        conditional = stmt.mask is not None or bool(hmasks)
        writers = sum(x.writes_name(t.name) for x in self._items([it.loop]))
        ct = _ctype(m.dtype)

        def rows_of_vectors(row_addr, et: str, size: int) -> None:
            vt, per = _chunks(et, size, w)
            half = _HALF_TYPES.get(_np_dtype(m.dtype)) if et == "unsigned short" else None
            for pi in range(rows):
                for c in range(0, w, per):
                    vals = [f"gt_v{pi}_{c + e}" for e in range(per)]
                    if half:
                        pack = "gt_pack_h" if half[0] == "__half" else "gt_pack_bf"
                        words = [f"{pack}({a}, {z})" for a, z in zip(vals[::2], vals[1::2])]
                        value = words[0] if vt == "unsigned" else f"make_{vt}({', '.join(words)})"
                    else:
                        value = f"make_{vt}({', '.join(vals)})"
                    self.emit(f"*({vt}*)({row_addr(pi, c)}) = {value};")

        def point(pi: int, pj: int, store: str, tile: bool) -> None:
            terms = [self._extent_cond(it.ext)]
            if tile:
                terms.append(self._tile_cond(it.ext, f"gt_r + {pi}", f"gt_c + {pj}"))
            if stmt.mask is not None:
                terms.append(f"gt_m{pi}_{pj}")
            if hmasks:
                terms.append(self._region_cond(hmasks))
            with self._block(""):
                self.emit(f"const int i = i0 + gt_r + ({pi}), j = j0 + gt_c + ({pj});")
                self.emit(f"if ({' && '.join(terms)}) {store}")

        if b is not None:  # a temporary's shared plane
            def shared(pi: int, c: int) -> str:
                return f"{m.var}_s + {m.var}_x + ({pi * b.cols + c})"

            vt, _ = _chunks(ct, np.dtype(_compute(m.dtype)).itemsize, w)
            if vt and not conditional and writers == 1 and not b.init:
                rows_of_vectors(shared, ct, np.dtype(_compute(m.dtype)).itemsize)
                return
            for pi in range(rows):
                for pj in range(w):
                    point(pi, pj, f"{m.var}_s[{m.var}_x + ({pi * b.cols + pj})] = gt_v{pi}_{pj};", True)
            return

        size = m.dtype.itemsize
        vt, _ = _chunks(_raw(m.dtype), size, w)
        scope = self._block("")
        if vt and not conditional:
            with self._block(f"if ({self._vector_flag(m, plan)} && gt_inner)"):
                rows_of_vectors(
                    lambda pi, c: f"{m.var}_b + ({pi} * {m.var}_si4 + {c * size})", _raw(m.dtype), size
                )
            scope = self._block("else")
        with scope:
            for pi in range(rows):
                for pj in range(w):
                    self.point_base = {t.name: f"({m.var}_b + ({pi} * {m.var}_si4 + {pj} * {m.var}_sj4))"}
                    point(pi, pj, self._global_store(t, f"gt_v{pi}_{pj}"), False)
                    self.point_base = {}

    # -- the column kernel -----------------------------------------------------

    def _check_column(self, vloop: gtir.VerticalLoop) -> None:
        writes, reads = _loop_symbols(vloop)
        written = {w.name for w in writes}
        for w in writes:
            if w.offset[0] != 0 or w.offset[1] != 0:
                raise CudaUnsupported(f"horizontal offset write to '{w.name}'")
        for r in reads:
            if r.name in written and (r.offset[0] != 0 or r.offset[1] != 0):
                raise CudaUnsupported(
                    f"'{r.name}' is written and read at a horizontal offset in one "
                    "vertical loop (columns would race)"
                )
        if vloop.loop_order == gtir.LoopOrder.PARALLEL:
            for section in vloop.sections:
                for stmt in section.body:
                    targets = {w.name for w in iter_writes(stmt)}
                    for r in _iter_reads(stmt):
                        if r.name in targets and (
                            r.offset[2] != 0 or r.koffset is not None or r.abs_k is not None
                        ):
                            raise CudaUnsupported(
                                f"PARALLEL statement reads its own target '{r.name}' "
                                "at a K offset"
                            )

    def _emit_column_kernel(self, n: int, vloop: gtir.VerticalLoop) -> None:
        """Two variants of one skeleton: ``gt_column_<n>`` with plain
        pointers, for any arguments, and ``gt_column_<n>_r`` taking the
        field pointers as ``__restrict__`` parameters (read-only ones
        ``const``), for arguments whose buffers do not overlap. With no
        aliasing to fear, the compiler forwards a value a thread stored to
        its later loads, and a FORWARD or BACKWARD walk reads what it can
        from its prefetch ring (:meth:`_plan_ring`) instead of waiting on
        each level's loads."""
        self._check_column(vloop)
        writes, reads = _loop_symbols(vloop)
        names = {a.name for a in writes + reads}
        written = {a.name for a in writes}
        stmts = [s for section in vloop.sections for s in section.body]
        union = Extent.zeros()
        for s in stmts:
            union = union.union(self.analyzed.stmt_extents[s])
        kernel = f"gt_column_{n}"
        params, args = self._restrict_args(names, written)
        ring = self._plan_ring(n, union, COL_BJ * COL_BI)
        smem = ring.bytes if ring else 0
        self._emit_column_variant(kernel, n, vloop, names, union, "", None)
        self.read_only = names - written
        self._emit_column_variant(kernel + "_r", n, vloop, names, union, params, ring)
        self.read_only = set()
        if ring:
            self.ring_bytes[kernel + "_r"] = smem
        ni_u = f"ni + ({union.i[1] - union.i[0]})"
        nj_u = f"nj + ({union.j[1] - union.j[0]})"
        self._emit_launcher(
            n,
            kernel,
            f"(unsigned)(({nj_u} + {COL_BJ - 1}) / {COL_BJ}), "
            f"(unsigned)(({ni_u} + {COL_BI - 1}) / {COL_BI}), 1u",
            f"{COL_BJ}, {COL_BI}",
            noalias_call=(
                f"{kernel}_r<<<grid, block, {smem}, (cudaStream_t)stream>>>"
                f"(p{', ' if args else ''}{args})"
            ),
            noalias_smem=smem,
            on_chip=True,
        )

    def _emit_column_variant(self, kernel, n, vloop, names, union, params: str, ring) -> None:
        extra = f", {params}" if params else ""
        self.emit(
            f"__global__ void __launch_bounds__({COL_BJ * COL_BI}{_ring_blocks(ring)}) "
            f"{kernel}(const GtParams p{extra}) {{"
        )
        self.indent += 1
        self._emit_locals(names, pointers=not params)
        self.emit(
            f"const long long j = ({union.j[0]}) + (long long)blockIdx.x * {COL_BJ} + threadIdx.x;"
        )
        self.emit(
            f"const long long i = ({union.i[0]}) + (long long)blockIdx.y * {COL_BI} + threadIdx.y;"
        )
        self.emit(f"if (i >= ni + ({union.i[1]}) || j >= nj + ({union.j[1]})) return;")
        self.point_base = {}
        self._emit_registers(h for h in self.held.values() if h.writer == n)
        if ring:
            self._emit_ring_memory()
        if vloop.loop_order == gtir.LoopOrder.PARALLEL:
            for section in vloop.sections:
                lo, hi = self._k_bound(section.interval.start), self._k_bound(section.interval.end)
                for stmt in section.body:
                    with self._block(f"for (long long k = {lo}; k < {hi}; ++k)"):
                        self._emit_guarded(stmt, union)
        else:
            first = sum(len(v.sections) for v in self.stencil.vertical_loops[:n])
            self._emit_walk(n, vloop, union, first, ring)
        self.indent -= 1
        self.emit("}")
        self.emit()

    def _emit_on_chip_kernel(self, n: int) -> None:
        """``gt_column_<n>_<n + 1>_r``: loop ``n``'s FORWARD walk and loop
        ``n + 1``'s BACKWARD walk, back to back in one thread per column of
        the two loops' statement extents, each statement guarded by its own.
        Each walk is ``column``'s, with its registers, carries and prefetch
        ring (the two rings share one region, as ``fused_column``'s walks
        do, ``ON_CHIP_RING_LEVELS`` deep); where ``column`` stores a cross
        value to its (K, I, J) buffer and the BACKWARD kernel reads it back,
        this one stores it to the thread's element of a slab of dynamic
        shared memory after the ring, laid out [k][value][thread] so that a
        warp's 32 threads hit 32 banks, and reads it back from there. The
        slab takes nk levels, so the launcher chooses this kernel from nk
        (:class:`OnChip`); a pair whose slab would not fit one level is
        left to the two kernels."""
        loops = self.stencil.vertical_loops
        cross = self.pairs[n]
        items = self._items([n, n + 1])
        names = {a.name for it in items for a in it.reads + it.writes} - set(cross)
        written = {w.name for it in items for w in it.writes}
        union = Extent.zeros()
        for it in items:
            union = union.union(it.ext)
        threads = 32 * ON_CHIP_ROWS
        rings = self._shared_rings(
            [(n + d, ON_CHIP_RING_LEVELS[d], frozenset(cross)) for d in (0, 1)], union, threads
        )
        ring_bytes = max((r.bytes for r in rings if r), default=0)
        metas = sorted((self.fields[c] for c in cross), key=lambda m: -m.dtype.itemsize)
        self.slab, offset = {}, 0
        for m in metas:
            self.slab[m.name] = offset
            offset += threads * m.dtype.itemsize
        self.slab_level = offset
        # the largest nk whose slab leaves ON_CHIP_RESIDENT_BYTES resident
        item = max(
            (st.meta.dtype.itemsize for r in rings if r for st in r.streams),
            default=metas[0].dtype.itemsize,
        )
        blocks = -(-ON_CHIP_RESIDENT_BYTES // (threads * item))
        per_block = min(SHARED_BYTES_LIMIT, SM_SHARED_BYTES // blocks - BLOCK_RESERVED_BYTES)
        max_nk = (per_block - ring_bytes) // offset
        if max_nk < 1:
            self.slab = {}
            return
        kernel = f"gt_column_{n}_{n + 1}_r"
        params, args = self._restrict_args(names, written)
        self.read_only = names - written
        self.emit(f"__global__ void __launch_bounds__({threads}, 1) {kernel}(const GtParams p, {params}) {{")
        self.indent += 1
        self._emit_locals(names, pointers=False)
        self.emit(f"const long long j = ({union.j[0]}) + (long long)blockIdx.x * 32 + threadIdx.x;")
        self.emit(
            f"const long long i = ({union.i[0]}) + (long long)blockIdx.y * {ON_CHIP_ROWS} + threadIdx.y;"
        )
        self.emit(f"if (i >= ni + ({union.i[1]}) || j >= nj + ({union.j[1]})) return;")
        self.point_base = {}
        self._emit_registers(h for h in self.held.values() if h.writer in (n, n + 1))
        self._emit_ring_memory()
        self.emit(f"unsigned char* const gt_slab = gt_smem + {ring_bytes};")
        sid = sum(len(v.sections) for v in loops[:n])
        sid = self._emit_walk(n, loops[n], union, sid, rings[0])
        self._emit_walk(n + 1, loops[n + 1], union, sid, rings[1])
        self.indent -= 1
        self.emit("}")
        self.emit()
        self.read_only = set()
        self.slab = {}
        if ring_bytes:
            self.ring_bytes[kernel] = ring_bytes
        self.on_chip[n] = OnChip(
            kernel=kernel, cross=cross, ring_bytes=ring_bytes,
            level_bytes=self.slab_level, max_nk=max_nk,
        )
        self.on_chip_launch[n] = (args, union)

    def _emit_on_chip_launch(self, n: int) -> None:
        """The launcher's branch into :meth:`_emit_on_chip_kernel`'s kernel
        (loop ``n``'s launcher) or past the launch it took over (loop
        ``n + 1``'s), where :meth:`OnChip.serves` the shape."""
        oc = self.on_chip.get(n)
        if oc is not None:
            args, union = self.on_chip_launch[n]
            with self._block(f"if (noalias && nk <= {oc.max_nk})"):
                self.emit(
                    f"const dim3 gt_grid((unsigned)((nj + ({union.j[1] - union.j[0]}) + 31) / 32), "
                    f"(unsigned)((ni + ({union.i[1] - union.i[0]}) + {ON_CHIP_ROWS - 1}) / "
                    f"{ON_CHIP_ROWS}), 1u);"
                )
                self.emit(f"if (gt_grid.x == 0 || gt_grid.y == 0) return {NOTHING_LAUNCHED};")
                self.emit(f"const int gt_smem = {oc.ring_bytes} + (int)nk * {oc.level_bytes};")
                with self._block(f"if (gt_smem > {SHARED_BYTES_MAX})"):
                    self._emit_smem_allowance(oc.kernel, "gt_smem")
                self.emit(
                    f"{oc.kernel}<<<gt_grid, dim3(32, {ON_CHIP_ROWS}), gt_smem, "
                    f"(cudaStream_t)stream>>>(p, {args});"
                )
                self.emit("return (int)cudaGetLastError();")
        oc = self.on_chip.get(n - 1)
        if oc is not None:
            self.emit(f"if (noalias && nk <= {oc.max_nk}) return {NOTHING_LAUNCHED};")

    def _emit_registers(self, held) -> None:
        """Declare held temporaries' registers and their carries, at 0."""
        for h in held:
            ct, v = _ctype(h.meta.dtype), h.meta.var
            regs = [f"{v}_r"] + [f"{v}_r{d}" for d in range(1, h.ring + 1)]
            self.emit(f"{ct} {', '.join(f'{r} = ({ct})0' for r in regs)};")

    def _emit_walk(self, n: int, vloop, union: Extent, sid: int, ring: Optional[_Ring]) -> int:
        """Loop ``n`` level by level, in its sections' order: FORWARD and
        PARALLEL ascending, BACKWARD descending. At each level the registers
        of the temporaries it holds rotate their carries and restart at 0
        where its section does not first write them whole; ``ring``
        prefetches the levels the walk reads. Returns the next section's
        stencil-wide index."""
        self.loop = n
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        if ring:
            self.emit("{")
            self.indent += 1
            self._emit_ring_setup(ring, vloop, union)
            self.ring = ring
        for section in vloop.sections:
            lo = self._k_bound(section.interval.start)
            hi = self._k_bound(section.interval.end)
            head = (
                f"for (long long k = {hi} - 1; k >= {lo}; --k)"
                if backward
                else f"for (long long k = {lo}; k < {hi}; ++k)"
            )
            with self._block(head):
                if ring:
                    self.emit(f"const int gt_p = (int)({'gt_w0 - k' if backward else 'k - gt_w0'});")
                    self.emit(f"gt_fetch(gt_p + {ring.levels - 1});")
                    self.emit(f"gt_cp_wait<{ring.levels - 1 - ring.ahead}>();")
                for h in self.held.values():
                    if h.writer != n:
                        continue
                    ct, v = _ctype(h.meta.dtype), h.meta.var
                    for d in range(h.ring, 1, -1):
                        self.emit(f"{v}_r{d} = {v}_r{d - 1};")
                    if h.ring:
                        self.emit(f"{v}_r1 = {v}_r;")
                    if sid in h.reset:
                        self.emit(f"{v}_r = ({ct})0;")
                for stmt in section.body:
                    self._emit_guarded(stmt, union)
            sid += 1
        if ring:
            self.ring = None
            self.emit("gt_cp_wait_all();")
            self.indent -= 1
            self.emit("}")
        self.loop = -1
        return sid

    def _emit_guarded(self, stmt: gtir.Stmt, union: Extent) -> None:
        cond = self._extent_cond(self.analyzed.stmt_extents[stmt], union)
        if self.ring:
            self.ring_reads = self.ring.reads.get(id(stmt), frozenset())
        if cond == "1":
            with self._block(""):
                self._emit_stmt(stmt)
        else:
            with self._block(f"if ({cond})"):
                self._emit_stmt(stmt)
        self.ring_reads = frozenset()

    # -- the prefetch ring (column and fused_column, __restrict__ variants) ------

    def _plan_ring(
        self, n: int, union: Extent, threads: int, pitch: int = 0, levels: int = RING_LEVELS,
        slab: frozenset = frozenset(),
    ) -> Optional[_Ring]:
        """The Hopper counterpart of K3's pipelined plane streams
        (``spec_keys``, pallas_seq.py:1097-1134): each (field, horizontal
        offset) that loop ``n``'s FORWARD or BACKWARD walk reads is one
        stream, copied into the ring ``RING_LEVELS - 1`` levels ahead of the
        chain; its constant K offsets read neighbouring slots. A stream is
        (a) a 3-D field of 4 or 8 bytes without data dimensions that the
        loop does not write, at any constant K offset less than
        ``RING_LEVELS`` levels ahead of or behind the walk, or (b) one it
        writes only at its own point and level, outside any ``while``, read
        at the walk's level before the level's first write to it: its value
        from before the loop. The rest stays a direct load: a value the
        thread wrote (a register, or forwarded), reads further from the
        walk, at a variable or absolute K, in a ``while``, or at a
        horizontal offset in a horizontal region (its address may lie
        outside the allocation), tables, data dimensions and
        lower-dimensional fields, and half fields (``cp.async`` copies 4, 8
        or 16 bytes, never 2), and what the walk reads from the on-chip
        slab (``slab``: the cross values of :meth:`_plan_on_chip`). Streams
        are ringed in the order the walk first reads them as long as the
        ring stays within ``RING_BYTES_MAX``; the reads of the others stay
        direct loads too. ``levels`` replaces ``RING_LEVELS`` as the depth.
        A thread's element of a stream lies ``pitch`` bytes after the one
        before it (0: the stream's item size). None where the walk has no
        stream, is PARALLEL, or its sections do not run back to back;
        raises :class:`CudaUnsupported`, naming the bytes, where not even
        one stream fits."""
        vloop = self.stencil.vertical_loops[n]
        if vloop.loop_order == gtir.LoopOrder.PARALLEL or not self._chained(vloop):
            return None
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        items = self._items([n])
        written = {w.name for it in items for w in it.writes}
        level_writes = written - {
            a.name
            for it in items
            for a in (
                it.reads + it.writes
                if isinstance(it.stmt, gtir.While)
                else [w for w in it.writes if w.offset != (0, 0, 0) or w.koffset is not None]
            )
        }
        streams: dict[tuple, _Stream] = {}  # in the order the walk first reads them
        reach: dict[tuple, list[int]] = {}  # stream -> the levels its reads reach
        served: dict[int, list] = {}  # statement -> [(stream, (name, offset))]
        for sid in sorted({it.section for it in items}):
            before: set[str] = set()  # written earlier at this level
            for it in items:
                if it.section != sid:
                    continue
                served[id(it.stmt)] = []
                for r in () if isinstance(it.stmt, gtir.While) else it.reads:
                    m = self.fields.get(r.name)
                    di, dj, dk = r.offset
                    q = -dk if backward else dk
                    h = self.held.get(r.name)
                    if (
                        m is None
                        or m.axes != (True, True, True)
                        or m.data_dims
                        or m.dtype.itemsize not in (4, 8)
                        or r.koffset is not None
                        or r.abs_k is not None
                        or r.data_index
                        or (h is not None and h.writer == n)
                        or r.name in slab
                        or ((di or dj) and it.stmt.horizontal_masks)
                        or abs(q) >= levels
                        or (
                            r.name in written
                            and not (r.name in level_writes and dk == 0 and r.name not in before)
                        )
                    ):
                        continue
                    key = (r.name, di, dj)
                    s = streams.get(key)
                    if s is None:
                        streams[key] = _Stream(meta=m, di=di, dj=dj, ext=it.ext)
                    else:
                        s.ext = s.ext.union(it.ext)
                    reach.setdefault(key, []).append(q)
                    served[id(it.stmt)].append((key, (r.name, r.offset)))
                before |= {w.name for w in it.writes}
        if not streams:
            return None

        def size(keys: list) -> int:
            back = max(0, max(-q for key in keys for q in reach[key]))
            return (levels + back) * threads * sum(
                pitch or streams[key].meta.dtype.itemsize for key in keys
            )

        kept: list[tuple] = []
        for key in streams:
            if size(kept + [key]) <= RING_BYTES_MAX:
                kept.append(key)
        if not kept:
            need = min(size([key]) for key in streams)
            raise CudaUnsupported(
                f"loop {n}'s prefetch ring needs {need} bytes of shared memory per block "
                f"for one stream; a block may take {RING_BYTES_MAX}"
            )
        # 8-byte streams first: every element aligned
        ordered = sorted((streams[key] for key in kept), key=lambda s: -s.meta.dtype.itemsize)
        offset = 0
        for s in ordered:
            s.offset, s.pitch = offset, pitch or s.meta.dtype.itemsize
            offset += threads * s.pitch
        qs = [q for key in kept for q in reach[key]]
        return _Ring(
            streams=ordered,
            back=max(0, max(-q for q in qs)),
            ahead=max(0, max(qs)),
            backward=backward,
            reads={
                stmt: frozenset(read for key, read in reads if key in kept)
                for stmt, reads in served.items()
            },
            slot_bytes=offset,
            levels=levels,
        )

    def _shared_rings(self, walks, union: Extent, threads: int) -> list:
        """The rings of walks (loop, depth, slab names) that one thread runs
        back to back in one region of shared memory with no barrier between
        them: a thread's elements must lie at the same bytes in every walk,
        so where the walks mix 4- and 8-byte streams every stream takes the
        larger pitch."""
        rings = [self._plan_ring(n, union, threads, levels=lv, slab=sl) for n, lv, sl in walks]
        sizes = {st.meta.dtype.itemsize for r in rings if r for st in r.streams}
        if len(sizes) > 1:
            rings = [
                self._plan_ring(n, union, threads, pitch=max(sizes), levels=lv, slab=sl)
                for n, lv, sl in walks
            ]
        return rings

    def _emit_ring_memory(self) -> None:
        """The ring's shared address ``gt_sm`` and the thread's index in
        its block, ``gt_tid``."""
        self.emit("extern __shared__ __align__(16) unsigned char gt_smem[];")
        self.emit("const unsigned gt_sm = (unsigned)__cvta_generic_to_shared(gt_smem);")
        self.emit("const unsigned gt_tid = threadIdx.y * blockDim.x + threadIdx.x;")

    def _emit_ring_setup(self, ring: _Ring, vloop, union: Extent) -> None:
        """The walk's first level ``gt_w0`` and length ``gt_wn``, each
        stream's slot pointer and column address, ``gt_fetch(f)``, which
        copies the level ``f`` steps into the walk (clamped as ``gt_clampk``
        clamps a read, at the points of the statements reading the stream)
        and commits one group, and the prologue: the levels behind the walk
        its reads reach, and the first ``RING_LEVELS - 1``. The walk's
        sections run back to back (:meth:`_chained`), so it fetches its
        levels in order, one a call: each stream's address (``gt_a<s>``) and
        the slot (``gt_s``) step by one level a call, and only a level
        outside some stream's field (below ``gt_klo`` or from ``gt_khi`` on),
        which the walk's first and last fetches alone reach, computes the
        clamped addresses, on a branch marked unlikely so that the compiler
        keeps it off the levels' path (PERF.md: without the mark ptxas
        selects between both addresses at every fetch, and the on-chip pair
        loses 3 % in float64)."""
        first, last = vloop.sections[0].interval, vloop.sections[-1].interval
        step = "-" if ring.backward else "+"
        if ring.backward:
            top = self._k_bound(first.end)
            self.emit(f"const long long gt_w0 = {top} - 1, gt_wn = {top} - {self._k_bound(last.start)};")
        else:
            bottom = self._k_bound(first.start)
            self.emit(
                f"const long long gt_w0 = {bottom}, gt_wn = {self._k_bound(last.end)} - {bottom};"
            )
        fields = list(dict.fromkeys(st.meta.var for st in ring.streams))
        self.emit(f"long long gt_klo = -{fields[0]}_ok, gt_khi = {fields[0]}_nk - {fields[0]}_ok;")
        for v in fields[1:]:
            self.emit(f"if (-{v}_ok > gt_klo) gt_klo = -{v}_ok;")
            self.emit(f"if ({v}_nk - {v}_ok < gt_khi) gt_khi = {v}_nk - {v}_ok;")
        here, clamped, copies = [], [], []
        for s, st in enumerate(ring.streams):
            m, v = st.meta, st.meta.var
            self.emit(f"const unsigned gt_q{s} = gt_sm + {st.offset}u + gt_tid * {st.pitch}u;")
            self.emit(
                f"const char* const gt_g{s} = {v} + ({v}_oi + i + ({st.di})) * {v}_si"
                f" + ({v}_oj + j + ({st.dj})) * {v}_sj;"
            )
            first_k = f"gt_w0 {'+' if ring.backward else '-'} {ring.back}"
            self.emit(f"const char* gt_a{s} = gt_g{s} + ({v}_ok + {first_k}) * {v}_sk;")
            here.append(f"const char* gt_c{s} = gt_a{s};")
            clamped.append(f"gt_c{s} = gt_g{s} + gt_clampk({v}_ok + gt_k, {v}_nk) * {v}_sk;")
            copy = f"gt_cp_async{m.dtype.itemsize}(gt_q{s} + gt_s * {ring.slot_bytes}u, gt_c{s});"
            cond = self._extent_cond(st.ext, union)
            copies.append(copy if cond == "1" else f"if ({cond}) {copy}")
        self.emit("unsigned gt_s = 0u;")
        self.emit("auto gt_fetch = [&](const int gt_f) {")
        self.indent += 1
        with self._block(f"if (gt_f < gt_wn + {ring.ahead})"):
            self.emit(f"const long long gt_k = gt_w0 {step} gt_f;")
            for line in here:
                self.emit(line)
            with self._block("if (__builtin_expect(gt_k < gt_klo || gt_k >= gt_khi, 0))"):
                for line in clamped:
                    self.emit(line)
            for line in copies:
                self.emit(line)
        for s, st in enumerate(ring.streams):
            self.emit(f"gt_a{s} {step}= {st.meta.var}_sk;")
        self.emit(f"gt_s = gt_s == {ring.slots - 1}u ? 0u : gt_s + 1u;")
        self.emit("gt_cp_commit();")
        self.indent -= 1
        self.emit("};")
        self.emit(f"for (int gt_f = {-ring.back}; gt_f < {ring.levels - 1}; ++gt_f) gt_fetch(gt_f);")

    def _ring_access(self, node: gtir.FieldAccess) -> str:
        """A read the ring serves: its stream's slot of level k + dk."""
        ring = self.ring
        di, dj, dk = node.offset
        s = ring.stream(node.name, di, dj)
        q = -dk if ring.backward else dk
        ct = _ctype(ring.streams[s].meta.dtype)
        return (
            f"gt_lds_{ct}(gt_q{s} + (unsigned)(gt_p + {q + ring.back}) % {ring.slots}u"
            f" * {ring.slot_bytes}u)"
        )

    # -- the fused_column kernel -------------------------------------------------

    @staticmethod
    def _walk_bounds(vloop: gtir.VerticalLoop) -> list:
        """Each section's (first, last) bound in walk order."""
        secs = [s.interval for s in vloop.sections]
        if vloop.loop_order == gtir.LoopOrder.BACKWARD:
            return [(iv.end, iv.start) for iv in secs]
        return [(iv.start, iv.end) for iv in secs]

    @classmethod
    def _chained(cls, vloop: gtir.VerticalLoop) -> bool:
        """The sections run back to back in walk order: each starts where
        the one before ends, so the walk visits a contiguous run of levels
        (each once: the stencil's ``min_sequential_axis_size`` keeps every
        section's size at 0 or more)."""
        bounds = cls._walk_bounds(vloop)
        return all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))

    @classmethod
    def _walk(cls, vloop: gtir.VerticalLoop) -> tuple[gtir.LevelMarker, bool]:
        """The marker a loop's walk starts from, and whether its sections
        cover the K range back to back in walk order (K4's full-K-range
        check, pallas_seq.py:1510-1520)."""
        S, E = gtir.LevelMarker.START, gtir.LevelMarker.END
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        bounds = cls._walk_bounds(vloop)
        if backward:
            first, last = gtir.AxisBound(level=E, offset=0), gtir.AxisBound(level=S, offset=0)
        else:
            first, last = gtir.AxisBound(level=S, offset=0), gtir.AxisBound(level=E, offset=0)
        return (E if backward else S), (
            bool(bounds) and cls._chained(vloop) and bounds[0][0] == first and bounds[-1][1] == last
        )

    def _reset_sections(
        self, secs: dict[int, list[_Item]], name: str, depth: int, cover: Extent
    ) -> frozenset[int]:
        """The sections at whose levels a held temporary's register starts
        at 0, the plain version's zero-filled temporary: where the level's
        value is read, or carried to the next level (``depth``), and the
        section does not first write it, unconditionally, at every point
        of ``cover`` (the columns the threads run)."""
        return frozenset(
            sid
            for sid, sec in secs.items()
            if (depth or any(
                a.name == name and not _is_k_shift(a)
                for it in sec for a in it.reads + it.writes
            ))
            and not (
                any(it.writes_name(name) for it in sec)
                and self._first_access_covers(sec, name, cover)
            )
        )

    def _plan_held(self, *, fused: bool) -> tuple[dict[str, _Held], dict[str, bool], int]:
        """column and fused_column: the temporaries kept in registers, loop
        by loop, for each temporary that keeps a (K, I, J) buffer whether
        the wrapper zero-fills it, and the smallest K for which the unfilled
        buffers hold every level a read reaches.

        A temporary is a register in the one loop that writes it (and no
        earlier loop touches) where :meth:`_register` says so; a later loop
        that reads it reads a buffer the register is stored to, level by
        level (``cross``). A buffer is zero-filled unless one loop writes
        it, no loop reads it before that one, the writer reads it only from
        its register, and every later read is at a constant K offset of a
        level the writer sets in full at the points read (``_levels_set``).
        ``column`` serves every K the stencil takes, so a buffer whose
        reads need a taller domain is zero-filled; ``fused_column`` (every
        loop walks level by level, and the class checks of
        :meth:`_plan_fused_column` have passed) fills none for that and
        serves only that K and above (``min_nk``)."""
        loops = self.stencil.vertical_loops
        items = self._items(range(len(loops)))
        min_k = math.inf if fused else self.analyzed.domain_info.min_sequential_axis_size
        held: dict[str, _Held] = {}
        fill: dict[str, bool] = {}
        min_nk = 0
        for m in self.fields.values():
            if not m.is_temp:
                continue
            name = m.name
            mine = [it for it in items if any(a.name == name for a in it.reads + it.writes)]
            writers = {it.loop for it in mine if it.writes_name(name)}
            w = min(writers) if len(writers) == 1 and min(it.loop for it in mine) in writers else None
            h = None if w is None else self._register(
                name, w, [it for it in mine if it.loop == w], min_k, fused
            )
            if h is not None:
                h.cross = any(it.loop > w for it in mine)
                held[name] = h
            if h is None or h.cross:
                tall = self._levels_read(name, w, mine, h is not None)
                fill[name] = tall is None or tall > min_k
                if not fill[name]:
                    min_nk = max(min_nk, tall)
        return held, fill, min_nk

    def _register(
        self, name: str, w: int, mine: list[_Item], min_k: float, fused: bool
    ) -> Optional[_Held]:
        """The register ``name`` is in loop ``w``, or None: the loop runs
        level by level (FORWARD or BACKWARD, or any loop of ``fused``) with
        sections back to back (``_chained``), and there every access to the
        temporary is outside any ``while``, every write at its own point and
        level, every read at the thread's own column and at a constant K
        offset at or behind the walk. A carry read in a section whose walk
        starts from the other end of the K range (``interval(-1, None)`` in
        a FORWARD loop) must find its level at 0 or above for every K of at
        least ``min_k``: below it a read would be clamped to the allocation,
        which the register cannot follow."""
        vloop = self.stencil.vertical_loops[w]
        if (vloop.loop_order == gtir.LoopOrder.PARALLEL and not fused) or not self._chained(vloop):
            return None
        start, _ = self._walk(vloop)
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        depth = 0
        for it in mine:
            if isinstance(it.stmt, gtir.While):
                return None
            if any(
                a.name == name and (a.offset != (0, 0, 0) or a.koffset is not None)
                for a in it.writes
            ):
                return None
            for r in it.reads:
                if r.name != name:
                    continue
                dk = r.offset[2]
                if r.koffset is not None or r.abs_k is not None or r.offset[0] or r.offset[1]:
                    return None
                if dk and (dk > 0) != backward:
                    return None  # ahead of the walk
                first = it.interval.end if backward else it.interval.start
                if dk and first.level != start and abs(first.offset) + abs(dk) > min_k:
                    return None
                depth = max(depth, abs(dk))
        first_sid = sum(len(v.sections) for v in self.stencil.vertical_loops[:w])
        loop_items = self._items([w])
        cover = Extent.zeros()
        for it in loop_items:
            cover = cover.union(it.ext)
        secs = {
            sid: [it for it in loop_items if it.section == sid]
            for sid in range(first_sid, first_sid + len(vloop.sections))
        }
        return _Held(
            meta=self.fields[name],
            writer=w,
            ring=depth,
            reset=self._reset_sections(secs, name, depth, cover),
        )

    def _levels_read(
        self, name: str, w: Optional[int], mine: list[_Item], held: bool
    ) -> Optional[int]:
        """The smallest K for which every read of a temporary's buffer finds
        a point and level that the loop writing it set, or None where a read
        may find one that no loop set (then the buffer is zero-filled)."""
        if w is None or any(
            r.name == name for it in mine if it.loop == w and not held for r in it.reads
        ):
            return None
        later = [(it, r) for it in mine if it.loop > w for r in it.reads if r.name == name]
        if any(r.koffset is not None or r.abs_k is not None for _, r in later):
            return None
        vloop = self.stencil.vertical_loops[w]
        first_sid = sum(len(v.sections) for v in self.stencil.vertical_loops[:w])
        loop_items = self._items([w])
        fulls = [
            any(
                _full_write(it, name)
                and all(_covers(it.ext, at.ext.shifted_ij(r.offset[0], r.offset[1])) for at, r in later)
                for it in loop_items
                if it.section == sid
            )
            for sid in range(first_sid, first_sid + len(vloop.sections))
        ]
        read_set, tall = self._levels_set(
            vloop, fulls, [_shifted(it.interval, r.offset[2]) for it, r in later]
        )
        return tall if read_set else None

    def _plan_on_chip(self) -> dict[int, tuple[str, ...]]:
        """column: the FORWARD loops whose walk and the BACKWARD walk of the
        loop after them one thread may run back to back in one launch
        (:meth:`_emit_on_chip_kernel`), each with the values the BACKWARD
        loop reads from the FORWARD one, which the launch keeps in shared
        memory. A pair qualifies where
        - every value the BACKWARD loop reads from the FORWARD one is a
          temporary the FORWARD loop keeps in a register (``cross``), whose
          buffer is not zero-filled (every read finds a level the walk set),
          read by no other loop, at the thread's own column and constant K
          offsets within the K range; an API field (tridiag's ``sup`` and
          ``rhs``) keeps the two launches;
        - K4's other conditions hold over the two loops, as
          :meth:`_plan_fused_column` checks them: 3-D fields without data
          dimensions and no tables, no ``while``, no offset write, no name
          written in both, no variable or absolute K, sections covering the
          K range back to back, and no read at a horizontal offset of what
          either writes: a column must not need another column's value,
          since the blocks no longer wait for each other between the walks."""
        loops = self.stencil.vertical_loops
        items = self._items(range(len(loops)))
        pairs = {}
        for n in range(len(loops) - 1):
            if (loops[n].loop_order, loops[n + 1].loop_order) != (
                gtir.LoopOrder.FORWARD, gtir.LoopOrder.BACKWARD
            ) or not (self._walk(loops[n])[1] and self._walk(loops[n + 1])[1]):
                continue
            pair = [it for it in items if it.loop in (n, n + 1)]
            writer: dict[str, int] = {}
            ok = True
            for it in pair:
                ok = ok and isinstance(it.stmt, gtir.Assign)
                for w in it.writes:
                    ok = ok and w.offset == (0, 0, 0) and w.koffset is None
                    ok = ok and writer.setdefault(w.name, it.loop) == it.loop
            for it in pair:
                for a in it.reads + it.writes:
                    m = self._meta(a.name)
                    ok = ok and (m.is_temp or (m.axes == (True, True, True) and not m.data_dims))
                for r in it.reads:
                    ok = ok and r.koffset is None and r.abs_k is None
                    ok = ok and not (r.name in writer and (r.offset[0] or r.offset[1]))
            cross = sorted({
                r.name for it in pair if it.loop == n + 1 for r in it.reads
                if writer.get(r.name) == n
            })
            for name in cross:
                h = self.held.get(name)
                ok = ok and (
                    h is not None and h.writer == n and h.cross and not self.fill[name]
                    and self.fields[name].extent.k == (0, 0)
                    and not any(
                        it.loop > n + 1 and any(a.name == name for a in it.reads)
                        for it in items
                    )
                )
            if ok and cross:
                pairs[n] = tuple(cross)
        return pairs

    def _plan_fused_column(self) -> tuple[dict[str, _Held], dict[str, bool], int]:
        """K4's class among the stencils ``column`` serves: the conditions of
        ``pallas_seq.build_staged_fn`` (:302-333, :1505-1520), and no read of
        another column's value. Returns what the kernel keeps on chip
        (:meth:`_plan_held`: every temporary is a register), which buffers
        are zero-filled, and the smallest K the kernel serves."""
        loops = self.stencil.vertical_loops
        if len(loops) < 2:
            raise CudaUnsupported("one vertical loop: nothing to fuse")
        for p in self.stencil.params:
            if isinstance(p, gtir.GlobalTableDecl) or (
                isinstance(p, gtir.FieldDecl)
                and (tuple(p.dimensions) != (True, True, True) or p.data_dims)
            ):
                raise CudaUnsupported(f"'{p.name}' is a table, lower-dimensional or has data dims")
        items = self._items(range(len(loops)))
        writer: dict[str, int] = {}
        for it in items:
            if not isinstance(it.stmt, gtir.Assign):
                raise CudaUnsupported("while loop")
            for w in it.writes:
                if w.offset != (0, 0, 0) or w.koffset is not None:
                    raise CudaUnsupported(f"offset write to '{w.name}'")
                if writer.setdefault(w.name, it.loop) != it.loop:
                    raise CudaUnsupported(f"'{w.name}' is written in two vertical loops")
        min_nk = 0
        for it in items:
            vloop = loops[it.loop]
            start, _ = self._walk(vloop)
            for r in it.reads:
                m = self._meta(r.name)
                if r.koffset is not None or r.abs_k is not None:
                    raise CudaUnsupported(f"variable or absolute K read of '{r.name}'")
                if r.name not in writer:
                    if m.is_temp:
                        raise CudaUnsupported(f"temporary '{r.name}' is read but never written")
                    continue
                if r.offset[0] or r.offset[1]:
                    raise CudaUnsupported(
                        f"'{r.name}' is read at a horizontal offset: another column's value"
                    )
                if m.is_temp and it.loop < writer[r.name]:
                    raise CudaUnsupported(f"temporary '{r.name}' is read before it is written")
                if m.is_temp and it.loop > writer[r.name] and m.extent.k != (0, 0):
                    raise CudaUnsupported(f"'{r.name}' is read beyond the K range")
                dk = r.offset[2]
                if it.loop != writer[r.name] or dk == 0:
                    continue
                if vloop.loop_order == gtir.LoopOrder.PARALLEL:
                    raise CudaUnsupported(
                        f"PARALLEL loop reads '{r.name}', which it writes, at a K offset"
                    )
                backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
                if (dk > 0) != backward:
                    if m.is_temp:  # K4: "original K-offset read of loop-local temp"
                        raise CudaUnsupported(f"'{r.name}' is read ahead of the walk")
                    continue  # an API field's value from before the loop: device memory
                # a carry: the walk must have visited level k + dk (K4
                # declines a ring that needs seeding, pallas_seq.py:1506-1509)
                first = it.interval.end if backward else it.interval.start
                gap = abs(first.offset)
                if first.level == start and gap < abs(dk):
                    raise CudaUnsupported(f"carry of '{r.name}' needs seeding before the walk")
                if first.level != start:  # gap nk - |offset| levels
                    min_nk = max(min_nk, gap + abs(dk))
        for vloop in loops:
            if not self._walk(vloop)[1]:
                raise CudaUnsupported("a loop's sections do not cover the K range back to back")
        held, fill, tall = self._plan_held(fused=True)
        for name in writer:
            if self.fields[name].is_temp and name not in held:
                raise CudaUnsupported(f"temporary '{name}' cannot be kept in a register")
        return held, fill, max(min_nk, tall)

    @staticmethod
    def _levels_set(
        vloop: gtir.VerticalLoop, fulls: list[bool], reads: list[gtir.Interval]
    ) -> tuple[bool, int]:
        """Whether every read interval lies within a run of back-to-back
        sections that set the value in full, and the smallest K for which
        that holds (a bound from START lies below one from END only once
        the domain is tall enough)."""
        runs: list[gtir.Interval] = []
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        for n, (section, full) in enumerate(zip(vloop.sections, fulls)):
            iv = section.interval
            if full and n and fulls[n - 1]:
                last = runs[-1]
                runs[-1] = gtir.Interval(
                    start=iv.start if backward else last.start,
                    end=last.end if backward else iv.end,
                )
            elif full:
                runs.append(iv)
        tall = [0]

        def le(a: gtir.AxisBound, b: gtir.AxisBound) -> bool:
            if a.level == b.level:
                return a.offset <= b.offset
            tall.append(a.offset - b.offset)
            return a.level == gtir.LevelMarker.START

        inside = all(
            any(le(run.start, iv.start) and le(iv.end, run.end) for run in runs)
            for iv in reads
        )
        return inside, max(tall)

    def _emit_fused_column_kernel(self) -> None:
        """One launch per stencil, in two variants as ``column``: plain
        pointers, and ``__restrict__`` ones for arguments that do not
        overlap."""
        items = self._items(range(len(self.stencil.vertical_loops)))
        names = {a.name for it in items for a in it.reads + it.writes}
        written = {w.name for it in items for w in it.writes}
        union = Extent.zeros()
        for it in items:
            union = union.union(it.ext)
        kernel = "gt_fused_column_0"
        params, args = self._restrict_args(names, written)
        loops = self.stencil.vertical_loops
        rings = self._shared_rings([(n, RING_LEVELS, frozenset()) for n in range(len(loops))],
                                   union, FC_THREADS)
        self._emit_fused_column_variant(kernel, names, union, "", [None] * len(loops))
        self.read_only = names - written
        self._emit_fused_column_variant(kernel + "_r", names, union, params, rings)
        self.read_only = set()
        smem = max((r.bytes for r in rings if r), default=0)
        if smem:
            self.ring_bytes[kernel + "_r"] = smem
        self._emit_fused_column_launcher(kernel, union, args, smem)

    def _emit_fused_column_variant(
        self, kernel: str, names, union: Extent, params: str, rings: list
    ) -> None:
        """The loops back to back, each walk with its ring from ``rings``
        (one region of shared memory, reused walk after walk)."""
        extra = f", {params}" if params else ""
        self.emit(
            f"__global__ void __launch_bounds__({FC_THREADS}{_ring_blocks(any(rings))}) "
            f"{kernel}(const GtParams p{extra}) {{"
        )
        self.indent += 1
        self._emit_locals(names, pointers=not params)
        self.emit(
            f"const long long j = ({union.j[0]}) + (long long)blockIdx.x * blockDim.x + threadIdx.x;"
        )
        self.emit(
            f"const long long i = ({union.i[0]}) + (long long)blockIdx.y * blockDim.y + threadIdx.y;"
        )
        self.emit(f"if (i >= ni + ({union.i[1]}) || j >= nj + ({union.j[1]})) return;")
        self._emit_registers(self.held.values())
        if any(rings):
            self._emit_ring_memory()
        self.point_base = {}
        sid = 0
        stored: set[str] = set()  # what this thread stored in earlier loops
        for n, vloop in enumerate(self.stencil.vertical_loops):
            ring = rings[n]
            if ring and any(s.meta.name in stored for s in ring.streams):
                # the ring copies values this thread stored in an earlier
                # loop: those stores come first
                self.emit("__threadfence();")
            sid = self._emit_walk(n, vloop, union, sid, ring)
            stored |= {w.name for it in self._items([n]) for w in it.writes}
        self.indent -= 1
        self.emit("}")
        self.emit()

    def _emit_fused_column_launcher(self, kernel: str, union: Extent, args: str, smem: int) -> None:
        ni_u = f"ni + ({union.i[1] - union.i[0]})"
        nj_u = f"nj + ({union.j[1] - union.j[0]})"
        rows = FC_THREADS // 32
        self._emit_launcher(
            0,
            kernel,
            f"(unsigned)(({nj_u} + 31) / 32), (unsigned)(({ni_u} + {rows - 1}) / {rows}), 1u",
            f"32, {rows}",
            noalias_call=(
                f"{kernel}_r<<<grid, block, {smem}, (cudaStream_t)stream>>>"
                f"(p{', ' if args else ''}{args})"
            ),
            noalias_smem=smem,
        )

    def _held_access(self, node: gtir.FieldAccess) -> Optional[str]:
        """column and fused_column: a temporary's register in the loop that
        writes it, its slab element in the BACKWARD walk of an on-chip pair,
        or None where a later loop reads it from device memory."""
        h = self.held[node.name]
        dk = node.offset[2]
        if self.loop != h.writer:
            if node.name in self.slab:
                return self._slab_element(node.name, f"gt_clampk(k + ({dk}), nk)" if dk else "k")
            return None
        return f"{h.meta.var}_r{abs(dk)}" if dk else f"{h.meta.var}_r"

    def _slab_element(self, name: str, level: str) -> str:
        """The thread's element of ``name`` at level ``level`` of the slab
        (:meth:`_emit_on_chip_kernel`)."""
        m = self.fields[name]
        return (
            f"(*({_ctype(m.dtype)}*)(gt_slab + (unsigned)({level}) * {self.slab_level}u + "
            f"{self.slab[name]}u + gt_tid * {m.dtype.itemsize}u))"
        )

    def _emit_held_assign(self, stmt: gtir.Assign, h: _Held) -> None:
        """column and fused_column: a temporary's write, to its register
        and, for a later loop, to device memory."""
        t = stmt.target
        ct, v = _ctype(h.meta.dtype), h.meta.var
        stores = [f"{v}_r = gt_v;"]
        if t.name in self.slab:
            stores.append(f"{self._slab_element(t.name, 'k')} = gt_v;")
        elif h.cross:
            stores.append(self._global_store(t, "gt_v"))
        body = f"{{ const {ct} gt_v = {self._expr(stmt.value)}; {' '.join(stores)} }}"
        self.emit(body if stmt.mask is None else f"if ({self._expr(stmt.mask)}) {body}")

    # -- fused_plane and tiled: plans --------------------------------------------

    def _items(self, loops) -> list[_Item]:
        """The top-level statements of the given vertical loops, in program
        order, with their section's stencil-wide index."""
        items: list[_Item] = []
        section_id = 0
        for n, vloop in enumerate(self.stencil.vertical_loops):
            for section in vloop.sections:
                if n in loops:
                    for stmt in section.body:
                        items.append(
                            _Item(
                                pos=len(items),
                                section=section_id,
                                interval=section.interval,
                                stmt=stmt,
                                ext=self.analyzed.stmt_extents[stmt],
                                reads=list(_iter_reads(stmt)),
                                writes=list(iter_writes(stmt)),
                                loop=n,
                            )
                        )
                section_id += 1
        return items

    def _check_accesses(self, items: list[_Item]) -> None:
        for it in items:
            for w in it.writes:
                if w.offset[0] != 0 or w.offset[1] != 0:
                    raise CudaUnsupported(f"horizontal offset write to '{w.name}'")
            for a in it.writes + it.reads:
                m = self._meta(a.name)
                if m.data_dims and len(a.data_index) != len(m.data_dims):
                    raise CudaUnsupported(f"partial data-dimension index of '{a.name}'")

    @staticmethod
    def _footprint(items: list[_Item], name: str, level_only: bool = False) -> Extent:
        """Points of a symbol's plane the statements write or read,
        relative to the tile (the union of write extents and shifted read
        extents; ``level_only``: reads of the current level only)."""
        fp: Optional[Extent] = None
        for it in items:
            exts = [it.ext for w in it.writes if w.name == name]
            exts += [
                it.ext.shifted_ij(r.offset[0], r.offset[1])
                for r in it.reads
                if r.name == name and not (level_only and r.offset[2])
            ]
            for e in exts:
                fp = e if fp is None else fp.union(e)
        assert fp is not None
        return Extent(i=fp.i, j=fp.j)

    @staticmethod
    def _nonlocal_read(items: list[_Item], name: str) -> bool:
        return any(
            r.name == name and (r.offset[0] != 0 or r.offset[1] != 0 or it.wide)
            for it in items
            for r in it.reads
        )

    @staticmethod
    def _lagged_read(items: list[_Item], name: str) -> bool:
        """An earlier level is read at points beyond those a writer of the
        loop computes there."""
        writers = [it for it in items if it.writes_name(name)]
        return any(
            r.name == name
            and r.offset[2] != 0
            and not all(_covers(w.ext, it.ext.shifted_ij(r.offset[0], r.offset[1])) for w in writers)
            for it in items
            for r in it.reads
        )

    @staticmethod
    def _first_access_covers(items: list[_Item], name: str, fp: Extent) -> bool:
        """In these statements (one section), the symbol's first access at
        the current level is an unconditional write of its whole plane."""
        for it in items:
            if any(r.name == name and not _is_k_shift(r) for r in it.reads):
                return False
            if it.writes_name(name):
                return _full_write(it, name) and _covers(it.ext, fp)
        return True

    @staticmethod
    def _load_hazard(items: list[_Item], name: str) -> bool:
        """A plane first loaded from device memory at a level holds, at halo
        points, what a neighbouring block may already have stored there at
        that level: a value one of these statements writes. The block
        computes every point its statements write, so a read after the
        level's last write finds its own value or, where no statement
        wrote, the one from before the level, however many statements
        write it. A read at other points before or in a statement that
        writes it may find a neighbour's value instead: such a plane is
        loaded from a snapshot the wrapper takes before the launch."""
        last = max((it.pos for it in items if it.writes_name(name)), default=-1)
        return any(
            it.pos <= last
            and r.name == name
            and not _is_k_shift(r)
            and (r.offset[0] != 0 or r.offset[1] != 0 or it.wide)
            for it in items
            for r in it.reads
        )

    def _shared_buffer(
        self, items: list[_Item], name: str, tile, ring: int = 1, level_only: bool = False
    ) -> _Buffer:
        m = self.fields[name]
        fp = self._footprint(items, name, level_only)
        return _Buffer(
            meta=m,
            kind="shared",
            fp=fp,
            rows=tile[0] + fp.i[1] - fp.i[0],
            cols=tile[1] + fp.j[1] - fp.j[0],
            nd=int(np.prod(m.data_dims)) if m.data_dims else 1,
            ring=ring,
        )

    @staticmethod
    def _layout(buffers: list[_Buffer], kernel: str) -> int:
        """Byte offsets of the buffers in dynamic shared memory (16-byte
        aligned); the total, checked against the H100's limit."""
        total = 0
        for b in buffers:
            b.offset = total
            total += b.bytes
        if total > SHARED_BYTES_LIMIT:
            raise CudaUnsupported(
                f"{kernel} needs {total} bytes of shared memory per block "
                f"(the H100 gives at most {SHARED_BYTES_LIMIT})"
            )
        return total

    def _plan_fused(self) -> list[_Buffer]:
        """K2's class: one block walks a K block of the whole stencil."""
        items = self._items(range(len(self.stencil.vertical_loops)))
        self._check_accesses(items)
        for it in items:
            for w in it.writes:
                if w.offset[2] != 0 or w.koffset is not None:
                    raise CudaUnsupported(f"K-offset write to '{w.name}' in a PARALLEL loop")
        written = {w.name for it in items for w in it.writes}
        touched = {a.name for it in items for a in it.reads + it.writes}
        buffers = []
        for m in self.fields.values():
            name = m.name
            if name not in touched:
                continue
            if not m.is_temp and not any(m.axes):
                buffers.append(_Buffer(meta=m, kind="table", fp=Extent.zeros()))
            elif m.is_temp or (name in written and self._nonlocal_read(items, name)):
                b = self._shared_buffer(items, name, (TI, TJ))
                mine = [it for it in items if any(a.name == name for a in it.reads + it.writes)]
                first = [it for it in mine if it.section == mine[0].section]
                needs_init = not (
                    self._first_access_covers(first, name, b.fp)
                    and all(_interval_within(it.interval, first[0].interval) for it in mine)
                )
                if needs_init:
                    # temporaries start from zeros, not memory
                    if not m.is_temp and self._load_hazard(items, name):
                        self.snapshots.setdefault(0, set()).add(name)
                    b.init = frozenset(it.section for it in mine)
                buffers.append(b)
            elif m.axes == (True, True, False) and name not in written:
                fp = self._footprint(items, name)
                buffers.append(
                    _Buffer(
                        meta=m,
                        kind="staged",
                        fp=fp,
                        rows=TI + fp.i[1] - fp.i[0],
                        cols=TJ + fp.j[1] - fp.j[0],
                        nd=int(np.prod(m.data_dims)) if m.data_dims else 1,
                    )
                )
        self.fused_bytes = self._layout(buffers, "fused_plane")
        self.tile_rings[0] = self._plan_tile_ring(
            items, buffers, (TI, TJ), PLANE_THREADS, self.fused_bytes, fused=True
        )
        return buffers

    def _plan_tiled(self, n: int) -> list[_Buffer]:
        """K5's class for loop ``n``: a K walk of TL_TI × TL_TJ tiles."""
        vloop = self.stencil.vertical_loops[n]
        items = self._items([n])
        self._check_accesses(items)
        order = vloop.loop_order
        written = {w.name for it in items for w in it.writes}
        if order == gtir.LoopOrder.PARALLEL:
            for it in items:
                for r in it.reads:
                    if r.name in written and _is_k_shift(r):
                        raise CudaUnsupported(
                            f"PARALLEL loop reads '{r.name}', which it writes, at a K offset"
                        )
        contiguous = all(
            (a.interval.start == b.interval.end)
            if order == gtir.LoopOrder.BACKWARD
            else (a.interval.end == b.interval.start)
            for a, b in zip(vloop.sections, vloop.sections[1:])
        )
        shared = [
            m for m in self.fields.values()
            if m.name in written and self._nonlocal_read(items, m.name)
        ]
        # a ring plane holds an earlier level only where this block computed
        # it; a read beyond that needs a neighbouring block's value of that
        # level, so the loop's levels wait on the neighbouring tiles
        if any(self._lagged_read(items, m.name) for m in shared):
            self.cooperative.add(n)
        coop = n in self.cooperative
        carries = {} if coop else self._plan_carries(n, items)
        self.tiled_carries[n] = carries
        backward = order == gtir.LoopOrder.BACKWARD
        buffers = []
        for m in shared:
            name = m.name
            reach = 0
            for it in items:
                accesses = [(w, True) for w in it.writes] + [(r, False) for r in it.reads]
                for a, is_write in accesses:
                    if a.name != name:
                        continue
                    if a.koffset is not None or a.abs_k is not None or (
                        is_write and a.offset[2] != 0
                    ):
                        raise CudaUnsupported(
                            f"'{name}' is read at other points and accessed at a variable "
                            "or absolute K, or written at a K offset"
                        )
                    dk = a.offset[2]
                    if (order == gtir.LoopOrder.FORWARD and dk > 0) or (
                        order == gtir.LoopOrder.BACKWARD and dk < 0
                    ):
                        raise CudaUnsupported(
                            f"'{name}' is read at K offset {dk}, ahead of the walk"
                        )
                    if not is_write and _is_carry(carries, a, backward):
                        continue  # a register
                    reach = max(reach, abs(dk))
            if coop:
                reach = 0  # earlier levels come from device memory
            if reach and not contiguous:
                raise CudaUnsupported(
                    f"'{name}' is read at a K offset in a loop whose sections are not contiguous"
                )
            b = self._shared_buffer(
                items, name, (TL_TI, TL_TJ), ring=reach + 1, level_only=coop
            )
            b.writers = frozenset(it.section for it in items if it.writes_name(name))
            init = set()
            for sid in sorted({it.section for it in items}):
                sec = [it for it in items if it.section == sid]
                if any(it.writes_name(name) for it in sec) and not self._first_access_covers(
                    sec, name, b.fp
                ):
                    if self._load_hazard(sec, name):
                        self.snapshots.setdefault(n, set()).add(name)
                    init.add(sid)
            b.init = frozenset(init)
            buffers.append(b)
            if m.is_temp and not coop and not init and self._on_chip_only(n, b, carries):
                self.no_buffer.add(name)
        total = self._layout(buffers, "tiled")
        self.tiled_bytes[n] = total
        if not coop and contiguous:
            self.tile_rings[n] = self._plan_tile_ring(
                items, buffers, (TL_TI, TL_TJ), TILED_THREADS, total, backward
            )
        return buffers

    def _plan_carries(self, n: int, items: list[_Item]) -> dict[str, tuple[int, Extent]]:
        """tiled: the values of loop ``n`` read at the thread's own point a
        level or more behind the walk that a register carries from level to
        level, as ``column`` carries its held temporaries: name -> (depth,
        extent). A thread computes the same point of a statement at every
        level, so where every write of the value is one unconditional
        statement over one extent, that extent fits one pass of the block's
        threads, every such read lies in a statement of that extent, and
        every level read is one a writing section set (``_levels_set``), the
        thread's register holds what device memory would."""
        vloop = self.stencil.vertical_loops[n]
        if vloop.loop_order == gtir.LoopOrder.PARALLEL:
            return {}
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        first = sum(len(v.sections) for v in self.stencil.vertical_loops[:n])
        out = {}
        for name in sorted({w.name for it in items for w in it.writes}):
            m = self.fields[name]
            writers = [it for it in items if it.writes_name(name)]
            ext = writers[0].ext
            rows, cols = TL_TI + ext.i[1] - ext.i[0], TL_TJ + ext.j[1] - ext.j[0]
            if (
                m.data_dims
                or rows * cols > TILED_THREADS
                or not all(_full_write(it, name) and it.ext == ext for it in writers)
                or (not m.is_temp and self._nonlocal_read(items, name))
            ):
                continue
            probe = {name: (1, ext)}
            behind = [(it, r) for it in items for r in it.reads if _is_carry(probe, r, backward)]
            if not behind or any(it.ext != ext for it, _ in behind):
                continue
            fulls = [
                any(it.section == first + s and it.writes_name(name) for it in writers)
                for s in range(len(vloop.sections))
            ]
            inside, tall = self._levels_set(
                vloop, fulls, [_shifted(it.interval, r.offset[2]) for it, r in behind]
            )
            if inside and tall <= self.analyzed.domain_info.min_sequential_axis_size:
                out[name] = (max(abs(r.offset[2]) for _, r in behind), ext)
        return out

    def _ring_holds(self, n: int, b: _Buffer, interval: gtir.Interval, dk: int) -> bool:
        """tiled: every level ``dk`` away from the levels of ``interval`` is
        one that a section writing ``b``'s symbol computes, so its ring
        holds the level whenever the section runs."""
        vloop = self.stencil.vertical_loops[n]
        first = sum(len(v.sections) for v in self.stencil.vertical_loops[:n])
        fulls = [first + s in b.writers for s in range(len(vloop.sections))]
        inside, tall = self._levels_set(vloop, fulls, [_shifted(interval, dk)])
        return inside and tall <= self.analyzed.domain_info.min_sequential_axis_size

    def _on_chip_only(self, n: int, b: _Buffer, carries) -> bool:
        """tiled: no read of ``b``'s temporary goes to device memory: no other
        loop touches it, and each read in loop ``n`` is a carry, a read of
        the current level in a section that writes it, or a read of a level
        its ring holds."""
        name = b.meta.name
        backward = self.stencil.vertical_loops[n].loop_order == gtir.LoopOrder.BACKWARD
        for it in self._items(range(len(self.stencil.vertical_loops))):
            if it.loop != n and any(a.name == name for a in it.reads + it.writes):
                return False
            for r in it.reads:
                if r.name != name or it.loop != n or _is_carry(carries, r, backward):
                    continue
                dk = r.offset[2]
                if dk == 0 and it.section not in b.writers:
                    return False
                if dk and not self._ring_holds(n, b, it.interval, dk):
                    return False
        return True

    def _plan_tile_ring(
        self, items: list[_Item], buffers: list[_Buffer], tile, threads: int, base: int,
        backward: bool = False, fused: bool = False, levels: int = TILE_RING_LEVELS,
        half: bool = False,
    ) -> list[_Buffer]:
        """tiled, fused_plane and plane, ``_r`` variants: the input-plane ring, the
        tile counterpart of ``column``'s (:meth:`_plan_ring`), at the most
        levels up to ``levels`` at which the block, ``base`` bytes
        of shared memory and its ring, leaves ``TILE_RESIDENT_THREADS``
        threads resident on an SM (at least 2). Each 3-D API field of 4 or
        8 bytes without data dimensions that the walk reads and holds in no
        other shared buffer is a ring of ``depth`` planes over the footprint
        of the reads it serves, plus one for each level behind the walk
        those reach. It serves a read at a constant K offset at most
        ``depth - 1`` levels behind the walk or ``depth - 2`` ahead, except
        one at a horizontal offset in a horizontal region (its address may
        lie outside the allocation); of a field any statement of the walk
        writes, in any section, only a read of the current level, outside
        any ``while``, before any statement of the level writes it
        (``fused``: before any statement of any loop writes it): its value
        from before the walk, at points this block alone writes. Fields are
        ringed in the order the walk first reads them while the ring stays
        within ``RING_BYTES_MAX`` and the block within the card's shared
        memory; the others' reads stay direct loads, as do a half
        field's (``cp.async`` has no 2-byte copy), unless ``half``: plane's
        ``_r`` variant copies one as vectors."""
        for depth in range(levels, 1, -1):
            ring = self._tile_ring_at(items, buffers, tile, base, depth, backward, fused, half)
            used = base + sum(b.bytes for b in ring) + BLOCK_RESERVED_BYTES
            if not ring or SM_SHARED_BYTES // used * threads >= TILE_RESIDENT_THREADS:
                break
        offset = base
        for b in ring:
            b.offset = offset
            offset += b.bytes
        return ring

    def _tile_ring_at(
        self, items: list[_Item], buffers: list[_Buffer], tile, base: int, depth: int,
        backward: bool, fused: bool, half: bool = False,
    ) -> list[_Buffer]:
        """:meth:`_plan_tile_ring`'s ring of ``depth`` levels."""
        held = {b.meta.name for b in buffers}
        serves: dict[str, dict] = {}  # name -> {id(stmt): {(name, offset)}}
        reach: dict[str, list[int]] = {}
        foot: dict[str, Extent] = {}
        for it in items:
            stmt = it.stmt
            is_while = isinstance(stmt, gtir.While)
            masked = bool(getattr(stmt, "horizontal_masks", ())) or (
                is_while and any(getattr(s, "horizontal_masks", ()) for s in stmt.body)
            )
            for r in it.reads:
                m = self.fields.get(r.name)
                di, dj, dk = r.offset
                q = -dk if backward else dk
                if (
                    m is None
                    or m.is_temp
                    or r.name in held
                    or m.axes != (True, True, True)
                    or m.data_dims
                    or not (m.dtype.itemsize in (4, 8) or (half and m.dtype in _HALF_TYPES))
                    or r.koffset is not None
                    or r.abs_k is not None
                    or r.data_index
                    or ((di or dj) and masked)
                    or -q > depth - 1
                    or q > depth - 2
                ):
                    continue
                # the ring copies a level before the walk reaches it, so of a
                # field any section writes, it may hold only what the read
                # finds there before the level's first write
                writes = [w for w in items if w.writes_name(r.name)]
                if writes and (
                    dk
                    or is_while
                    or any(
                        w.pos < it.pos for w in writes if fused or w.section == it.section
                    )
                ):
                    continue
                serves.setdefault(r.name, {}).setdefault(id(stmt), set()).add(
                    (r.name, r.offset)
                )
                reach.setdefault(r.name, []).append(q)
                e = it.ext.shifted_ij(di, dj)
                foot[r.name] = foot[r.name].union(e) if r.name in foot else e

        def planes(names: list[str]) -> list[_Buffer]:
            back = max(0, max(-q for name in names for q in reach[name]))
            out = []
            for name in names:
                fp = Extent(i=foot[name].i, j=foot[name].j)
                out.append(
                    _Buffer(
                        meta=self.fields[name], kind="input", fp=fp,
                        rows=tile[0] + fp.i[1] - fp.i[0], cols=tile[1] + fp.j[1] - fp.j[0],
                        ring=depth + back, serves=serves[name],
                    )
                )
            return out

        kept: list[str] = []
        for name in serves:
            trial = sum(b.bytes for b in planes(kept + [name]))
            if trial <= RING_BYTES_MAX and base + trial <= SHARED_BYTES_LIMIT:
                kept.append(name)
        return planes(kept) if kept else []

    def _other_level(self, it: _Item, r: gtir.FieldAccess) -> bool:
        """The K-offset read ``r`` of statement ``it`` reads another level
        than the current one at every level the statement runs: a register
        carry, or a level inside the K range for every K the stencil takes,
        so that no clamp brings it onto the current level."""
        backward = self.loop >= 0 and (
            self.stencil.vertical_loops[self.loop].loop_order == gtir.LoopOrder.BACKWARD
        )
        if _is_carry(self.carries, r, backward):
            return True
        iv = _shifted(it.interval, r.offset[2])
        min_k = self.analyzed.domain_info.min_sequential_axis_size
        S = gtir.LevelMarker.START
        low = iv.start.offset >= 0 if iv.start.level == S else iv.start.offset + min_k >= 0
        high = iv.end.offset <= min_k if iv.end.level == S else iv.end.offset <= 0
        return low and high

    def _hazard(self, since: list[_Item], it: _Item, alias: bool) -> bool:
        """A barrier must come before ``it``: since the last barrier, a
        statement wrote a symbol that ``it`` accesses, or read one that
        ``it`` writes, where another thread may take the point (the two
        statements' extents differ, or an access lies at a horizontal
        offset), or at any level (a variable or absolute K). A read that
        surely finds another level than the current one (:meth:`_other_level`)
        does not meet the level's writes; any other K-offset read may be
        clamped onto the current level. ``alias``: the API fields may share
        memory, so they count as one symbol."""

        def key(a) -> str:
            return "" if alias and a.name in api else a.name

        api = {n for n, m in self.fields.items() if not m.is_temp}
        for e in since:
            for w_side, r_side in ((e, it), (it, e)):
                for w in w_side.writes:
                    for a in r_side.reads + r_side.writes:
                        if key(a) != key(w):
                            continue
                        anywhere = any(
                            x.koffset is not None or x.abs_k is not None for x in (a, w)
                        )
                        if a.offset[2] and not anywhere and self._other_level(r_side, a):
                            continue
                        if (
                            anywhere
                            or e.ext != it.ext
                            or a.name != w.name
                            or a.offset[:2] != (0, 0)
                            or w.offset[:2] != (0, 0)
                        ):
                            return True
        return False

    # -- fused_plane and tiled: emission -----------------------------------------

    def _emit_ownership(self, ti: int, tj: int) -> None:
        """The points whose device memory this block stores: its tile, and
        at the domain's edge everything beyond it."""
        far = "(1LL << 62)"
        self.emit(f"const long long own_i0 = i0 == 0 ? -{far} : i0;")
        self.emit(f"const long long own_i1 = i0 + {ti} >= ni ? {far} : i0 + {ti};")
        self.emit(f"const long long own_j0 = j0 == 0 ? -{far} : j0;")
        self.emit(f"const long long own_j1 = j0 + {tj} >= nj ? {far} : j0 + {tj};")
        self.emit("(void)own_i0; (void)own_i1; (void)own_j0; (void)own_j1;")

    def _emit_buffer_pointers(self, buffers: list[_Buffer]) -> None:
        if buffers:
            self.emit("extern __shared__ __align__(16) unsigned char gt_smem[];")
        for b in buffers:
            ct = _raw(b.meta.dtype) if b.kind == "input" else _ctype(b.meta.dtype)
            self.emit(f"{ct}* const {b.meta.var}_s = ({ct}*)(gt_smem + {b.offset});")

    def _emit_unravel(self, m: FieldMeta, flat: str) -> None:
        """``gt_a += `` the byte offset of data-dimension element ``flat``
        (row-major over the data dimensions)."""
        self.emit(f"long long gt_r = {flat};")
        for d in reversed(range(len(m.data_dims))):
            self.emit(f"gt_a += (gt_r % {m.data_dims[d]}) * {m.var}_d{d}; gt_r /= {m.data_dims[d]};")

    def _emit_plane_fill(
        self, b: _Buffer, threads: int, *, level: bool, slot: str = "", kernel: int = 0
    ) -> None:
        """Fill a buffer's plane from device memory over its footprint
        (``level``: at level k), zeros where the tile overhangs the field;
        from the symbol's snapshot where kernel ``kernel`` takes one."""
        m, ct = b.meta, _ctype(b.meta.dtype)
        if m.name in self.snapshots.get(kernel, ()):
            m = self.snapshot_meta[m.name]
        v = m.var
        n = b.plane * b.nd
        dest = f"{slot} * {n} + q" if slot else "q"
        with self._block(f"for (int q = tid; q < {n}; q += {threads})"):
            pt = f"q / {b.nd}" if b.nd > 1 else "q"
            self.emit(f"const long long i = i0 + ({b.fp.i[0]}) + ({pt}) / {b.cols};")
            self.emit(f"const long long j = j0 + ({b.fp.j[0]}) + ({pt}) % {b.cols};")
            self.emit(f"{ct} gt_x = ({ct})0;")
            with self._block(f"if (i < ni + ({b.fp.i[1]}) && j < nj + ({b.fp.j[1]}))"):
                terms = [f"({v}_o{r} + {r}) * {v}_s{r}" for r, on in zip("ij", m.axes) if on]
                if level and m.axes[2]:
                    terms.append(f"({v}_ok + k) * {v}_sk")
                self.emit(f"const char* gt_a = {' + '.join([v] + terms)};")
                if b.nd > 1:
                    self._emit_unravel(m, f"q % {b.nd}")
                load = "__ldcg" if m.name in self.coherent else ""
                self.emit(f"gt_x = {_load(m, 'gt_a', load, const=True)};")
            self.emit(f"{b.meta.var}_s[{dest}] = gt_x;")

    def _emit_table_stage(self, b: _Buffer, threads: int) -> None:
        m, v = b.meta, b.meta.var
        with self._block(f"for (int q = tid; q < {b.elements}; q += {threads})"):
            self.emit(f"const char* gt_a = {v};")
            self._emit_unravel(m, "q")
            self.emit(f"{v}_s[q] = {_load(m, 'gt_a', const=True)};")

    def _emit_item(self, it: _Item, tile, threads: int) -> None:
        """One statement over the tile widened by its extent."""
        ext = it.ext
        rows = tile[0] + ext.i[1] - ext.i[0]
        cols = tile[1] + ext.j[1] - ext.j[0]
        self.ring_reads = frozenset(
            read
            for b in self.buffers.values()
            if b.kind == "input"
            for read in b.serves.get(id(it.stmt), ())
        )
        with self._block(f"for (int q = tid; q < {rows * cols}; q += {threads})"):
            self.emit(f"const long long i = i0 + ({ext.i[0]}) + q / {cols};")
            self.emit(f"const long long j = j0 + ({ext.j[0]}) + q % {cols};")
            with self._block(f"if ({self._extent_cond(ext)})"):
                self.point_base = {}
                names = {a.name for a in it.reads + it.writes}
                for name in sorted(names):
                    m = self._meta(name)
                    b = self.buffers.get(name)
                    if b is not None and b.kind != "table":
                        self.emit(
                            f"const int {m.var}_x = (int)((i - i0 - ({b.fp.i[0]})) * {b.cols}"
                            f" + (j - j0 - ({b.fp.j[0]})));"
                        )
                    # a ringed field's address at the point, for its reads
                    # the ring does not serve and for its stores
                    direct = b is not None and b.kind == "input" and (
                        it.writes_name(name)
                        or any(
                            r.name == name and (name, r.offset) not in self.ring_reads
                            for r in it.reads
                        )
                    )
                    if self.strategy == "fused_plane" and any(m.axes) and (
                        b is None or (b.kind == "shared" and not m.is_temp) or direct
                    ):
                        self._emit_field_base(m, with_k=True)
                if it.wide:
                    self.emit(
                        "const bool gt_own = i >= own_i0 && i < own_i1 && "
                        "j >= own_j0 && j < own_j1; (void)gt_own;"
                    )
                self.item = it
                self._emit_stmt(it.stmt)
                self.item = None
        self.ring_reads = frozenset()

    def _emit_statements(
        self, items: list[_Item], tile, threads: int, since: list, plane: Optional[tuple] = None,
        patch: Optional[_PatchPlan] = None,
    ) -> list:
        """Statements in order, a barrier before each that :meth:`_hazard`
        says needs one; ``since``: the statements since the last barrier
        that surely ran. ``plane``: the plane kernel's block, whose points
        :meth:`_emit_plane_item` maps; ``patch``: its ``_r`` kernel's
        patches (:meth:`_emit_patch_item`). Returns those after the last
        statement."""
        since = list(since)
        for it in items:
            if since and self._hazard(since, it, alias=not self.noalias):
                self.emit("__syncthreads();")
                since = []
            if patch:
                self._emit_patch_item(it, patch)
            elif plane:
                self._emit_plane_item(it, plane)
            else:
                self._emit_item(it, tile, threads)
            since.append(it)
        return since

    def _ring_span(self, ring: list[_Buffer], backward: bool) -> tuple[int, int]:
        """(back, ahead): how many levels behind and ahead of the walk the
        reads a tile ring serves reach."""
        qs = [
            -off[2] if backward else off[2]
            for b in ring for reads in b.serves.values() for _, off in reads
        ]
        return max(0, -min(qs)), max(0, max(qs))

    def _emit_tile_ring_setup(
        self, ring: list[_Buffer], threads: int, w0: str, wn: str, backward: bool,
    ) -> int:
        """The tile ring's shared address, ``gt_tfetch(f)`` (the whole block
        copies level ``f`` steps into the walk of every ringed plane with
        ``cp.async``, clamped as ``gt_clampk`` clamps a read, at the points
        of the footprint inside the widened domain; one commit group a
        level), and the prologue: the levels behind the walk its reads reach
        and the first ``depth - 1``. Returns (how far ahead the reads
        reach, the ring's depth)."""
        back, ahead = self._ring_span(ring, backward)
        depth = ring[0].ring - back
        self.emit("const unsigned gt_sm = (unsigned)__cvta_generic_to_shared(gt_smem);")
        self.emit(f"const long long gt_w0 = {w0}, gt_wn = {wn};")
        self.emit("auto gt_tfetch = [&](const int gt_f) {")
        self.indent += 1
        with self._block(f"if (gt_f < gt_wn + {ahead})"):
            self.emit(f"const long long gt_k = gt_w0 {'-' if backward else '+'} gt_f;")
            for b in ring:
                m, v, size = b.meta, b.meta.var, b.meta.dtype.itemsize
                with self._block(""):
                    self.emit(
                        f"const unsigned gt_d = gt_sm + {b.offset}u + "
                        f"(unsigned)gt_slot(gt_k, {b.ring}) * {b.plane * size}u;"
                    )
                    self.emit(
                        f"const char* const gt_g = {v} + gt_clampk({v}_ok + gt_k, {v}_nk) * {v}_sk;"
                    )
                    with self._block(f"for (int q = tid; q < {b.plane}; q += {threads})"):
                        self.emit(f"const long long i = i0 + ({b.fp.i[0]}) + q / {b.cols};")
                        self.emit(f"const long long j = j0 + ({b.fp.j[0]}) + q % {b.cols};")
                        self.emit(
                            f"if (i < ni + ({b.fp.i[1]}) && j < nj + ({b.fp.j[1]})) "
                            f"gt_cp_async{size}(gt_d + (unsigned)q * {size}u, "
                            f"gt_g + ({v}_oi + i) * {v}_si + ({v}_oj + j) * {v}_sj);"
                        )
        self.emit("gt_cp_commit();")
        self.indent -= 1
        self.emit("};")
        self.emit(
            f"for (int gt_f = {-back}; gt_f < {depth - 1}; ++gt_f) gt_tfetch(gt_f);"
        )
        return ahead, depth

    def _emit_level_start(self, ring: list[_Buffer], span: tuple[int, int], walk_pos: str) -> None:
        """The barrier that turns a level over: the level's planes have
        landed (the ring's wait) and no thread still reads the slots the
        level overwrites; then the ring starts the copies of the level
        ``depth - 1`` steps on. ``span``: (ahead, depth) of
        :meth:`_emit_tile_ring_setup`."""
        ahead, depth = span
        if ring:
            self.emit(f"const int gt_p = (int)({walk_pos});")
            self.emit(f"gt_cp_wait<{depth - 2 - ahead}>();")
        self.emit("__syncthreads();")
        if ring:
            self.emit(f"gt_tfetch(gt_p + {depth - 1});")

    def _emit_fused_plane_kernel(self) -> None:
        """One launch per stencil: stage the K-invariant data, then walk the
        block's levels through every statement of every vertical loop. Two
        variants: ``gt_fused_plane_0`` for any arguments, and
        ``gt_fused_plane_0_r``, which prefetches its inputs through the
        tile ring, for arguments that do not overlap."""
        kernel = "gt_fused_plane_0"
        ring = self.tile_rings.get(0, [])
        self._emit_fused_plane_variant(kernel, [])
        smem_r = self.fused_bytes
        if ring:
            self.noalias = True
            self._emit_fused_plane_variant(kernel + "_r", ring)
            self.noalias = False
            smem_r = ring[-1].offset + ring[-1].bytes
            self.ring_bytes[kernel + "_r"] = smem_r - self.fused_bytes
        self._emit_launcher(
            0,
            kernel,
            f"(unsigned)((nj + {TJ - 1}) / {TJ}), (unsigned)((ni + {TI - 1}) / {TI}), "
            f"(unsigned)((nk + {FP_TK - 1}) / {FP_TK})",
            f"{PLANE_THREADS}",
            smem=self.fused_bytes,
            noalias_call=(
                f"{kernel}_r<<<grid, block, {smem_r}, (cudaStream_t)stream>>>(p)" if ring else ""
            ),
            noalias_smem=smem_r,
        )

    def _emit_fused_plane_variant(self, kernel: str, ring: list[_Buffer]) -> None:
        plan = self.fused_plan
        loops = self.stencil.vertical_loops
        items = self._items(range(len(loops)))
        names = {a.name for it in items for a in it.reads + it.writes}
        names |= {self.snapshot_meta[x].name for x in self.snapshots.get(0, ())}
        self.buffers = {b.meta.name: b for b in plan + ring}
        self.emit(
            f"__global__ void __launch_bounds__({PLANE_THREADS}) {kernel}(const GtParams p) {{"
        )
        self.indent += 1
        self._emit_locals(names)
        self.emit(f"const long long i0 = (long long)blockIdx.y * {TI};")
        self.emit(f"const long long j0 = (long long)blockIdx.x * {TJ};")
        self.emit(f"const long long kb0 = (long long)blockIdx.z * {FP_TK};")
        self.emit(f"const long long kb1 = kb0 + {FP_TK} < nk ? kb0 + {FP_TK} : nk;")
        self.emit("const int tid = threadIdx.x;")
        self._emit_ownership(TI, TJ)
        self._emit_buffer_pointers(plan + ring)
        for b in plan:
            if b.kind == "table":
                self._emit_table_stage(b, PLANE_THREADS)
            elif b.kind == "staged":
                self._emit_plane_fill(b, PLANE_THREADS, level=False)
        span = (
            self._emit_tile_ring_setup(ring, PLANE_THREADS, "kb0", "kb1 - kb0", False)
            if ring else (0, 0)
        )
        with self._block("for (long long k = kb0; k < kb1; ++k)"):
            self._emit_level_start(ring, span, "k - gt_w0")
            inits = [b for b in plan if b.kind == "shared" and b.init]
            for b in inits:
                if b.meta.is_temp:
                    ct = _ctype(b.meta.dtype)
                    n = b.plane * b.nd
                    with self._block(f"for (int q = tid; q < {n}; q += {PLANE_THREADS})"):
                        self.emit(f"{b.meta.var}_s[q] = ({ct})0;")
                else:
                    self._emit_plane_fill(b, PLANE_THREADS, level=True)
            if inits:
                self.emit("__syncthreads();")
            since: list = []
            for sid in sorted({it.section for it in items}):
                sec = [it for it in items if it.section == sid]
                lo, hi = self._k_bound(sec[0].interval.start), self._k_bound(sec[0].interval.end)
                with self._block(f"if (k >= {lo} && k < {hi})"):
                    self._emit_statements(sec, (TI, TJ), PLANE_THREADS, since)
                # a barrier inside the section may not run: the section's
                # statements stay pending for the next
                since += sec
        if ring:
            self.emit("gt_cp_wait_all();")
        self.indent -= 1
        self.emit("}")
        self.emit()
        self.buffers = {}

    def _emit_tiled_kernel(self, n: int, vloop: gtir.VerticalLoop) -> None:
        """One launch per vertical loop: each block walks the loop's levels
        in order over its tile, in two variants as ``fused_plane``: the
        ``_r`` one prefetches its inputs through the tile ring and carries
        API fields in registers too. A cooperative loop: one variant, whose
        blocks walk the levels over every tile of theirs, each tile waiting
        for the neighbouring tiles its reads reach to finish the level
        before."""
        kernel = f"gt_tiled_{n}"
        grid = (
            f"(unsigned)((nj + {TL_TJ - 1}) / {TL_TJ}), (unsigned)((ni + {TL_TI - 1}) / {TL_TI}), 1u"
        )
        smem = self.tiled_bytes[n]
        if n in self.cooperative:
            self._emit_tiled_variant(n, vloop, kernel, [], cooperative=True)
            self._emit_launcher(n, kernel, grid, f"{TILED_THREADS}", smem=smem, cooperative=True)
            return
        ring = self.tile_rings.get(n, [])
        carries = self.tiled_carries.get(n, {})
        api_carries = any(not self.fields[c].is_temp for c in carries)
        self._emit_tiled_variant(n, vloop, kernel, [])
        smem_r = smem
        if ring or api_carries:
            self.noalias = True
            self._emit_tiled_variant(n, vloop, kernel + "_r", ring)
            self.noalias = False
        if ring:
            smem_r = ring[-1].offset + ring[-1].bytes
            self.ring_bytes[kernel + "_r"] = smem_r - smem
        self._emit_launcher(
            n,
            kernel,
            grid,
            f"{TILED_THREADS}",
            smem=smem,
            noalias_call=(
                f"{kernel}_r<<<grid, block, {smem_r}, (cudaStream_t)stream>>>(p)"
                if ring or api_carries else ""
            ),
            noalias_smem=smem_r,
        )

    def _emit_tiled_variant(
        self, n: int, vloop, kernel: str, ring: list[_Buffer], cooperative: bool = False
    ) -> None:
        plan = self.tiled_plans[n]
        items = self._items([n])
        names = {a.name for it in items for a in it.reads + it.writes}
        names |= {self.snapshot_meta[x].name for x in self.snapshots.get(n, ())}
        self.buffers = {b.meta.name: b for b in plan + ring}
        self.loop = n
        backward = vloop.loop_order == gtir.LoopOrder.BACKWARD
        self.carries = {
            name: c for name, c in self.tiled_carries.get(n, {}).items()
            if self.noalias or self.fields[name].is_temp
        }
        written = {w.name for it in items for w in it.writes}
        self.coherent = written if cooperative else set()
        flags = ", int* __restrict__ gt_flags" if cooperative else ""
        self.emit(
            f"__global__ void __launch_bounds__({TILED_THREADS}) "
            f"{kernel}(const GtParams p{flags}) {{"
        )
        self.indent += 1
        self._emit_locals(names)
        self.emit("const int tid = threadIdx.x;")
        if cooperative:
            self.emit(f"const long long gt_tj = (nj + {TL_TJ - 1}) / {TL_TJ};")
            self.emit(f"const long long gt_ti = (ni + {TL_TI - 1}) / {TL_TI};")
            self.emit("const long long gt_tiles = gt_ti * gt_tj;")
            self.emit("int gt_step = 0;")
        else:
            self.emit(f"const long long i0 = (long long)blockIdx.y * {TL_TI};")
            self.emit(f"const long long j0 = (long long)blockIdx.x * {TL_TJ};")
            self._emit_ownership(TL_TI, TL_TJ)
        self._emit_buffer_pointers(plan + ring)
        for name, (depth, _) in sorted(self.carries.items()):
            ct, v = _ctype(self.fields[name].dtype), self.fields[name].var
            regs = [f"{v}_r"] + [f"{v}_r{d}" for d in range(1, depth + 1)]
            self.emit(f"{ct} {', '.join(f'{r} = ({ct})0' for r in regs)};")
        sids = sorted({it.section for it in items})
        self.loop_sections = [
            (sid, next(it.interval for it in items if it.section == sid)) for sid in sids
        ]
        span = (0, 0)
        if ring:
            first, last = vloop.sections[0].interval, vloop.sections[-1].interval
            if backward:
                top = self._k_bound(first.end)
                w0, wn = f"{top} - 1", f"{top} - {self._k_bound(last.start)}"
            else:
                w0 = self._k_bound(first.start)
                wn = f"{self._k_bound(last.end)} - {w0}"
            span = self._emit_tile_ring_setup(ring, TILED_THREADS, w0, wn, backward)
        for sid, interval in self.loop_sections:
            sec = [it for it in items if it.section == sid]
            self.section_writes = {w.name for it in sec for w in it.writes}
            lo, hi = self._k_bound(interval.start), self._k_bound(interval.end)
            walk = (
                f"for (long long k = {hi} - 1; k >= {lo}; --k)"
                if backward
                else f"for (long long k = {lo}; k < {hi}; ++k)"
            )
            with self._block(walk):
                if cooperative:
                    with self._block(
                        "for (long long gt_t = blockIdx.x; gt_t < gt_tiles; gt_t += gridDim.x)"
                    ):
                        self._emit_tile_wait(n, items)
                        self._emit_tiled_level(plan, sec, sid)
                        self.emit("__syncthreads();")
                        self.emit(
                            "if (tid == 0) { __threadfence(); "
                            "gt_flag_store(gt_flags + gt_t, gt_step + 1); }"
                        )
                    self.emit("++gt_step;")
                else:
                    self._emit_level_start(ring, span, "gt_w0 - k" if backward else "k - gt_w0")
                    for name, (depth, _) in sorted(self.carries.items()):
                        v = self.fields[name].var
                        for d in range(depth, 1, -1):
                            self.emit(f"{v}_r{d} = {v}_r{d - 1};")
                        self.emit(f"{v}_r1 = {v}_r;")
                    self._emit_tiled_level(plan, sec, sid)
        if ring:
            self.emit("gt_cp_wait_all();")
        self.indent -= 1
        self.emit("}")
        self.emit()
        self.buffers = {}
        self.section_writes = set()
        self.carries = {}
        self.coherent = set()
        self.loop = -1

    def _emit_tiled_level(self, plan: list[_Buffer], sec: list[_Item], sid: int) -> None:
        """One level of a tiled walk over one tile, after its first barrier:
        the shared planes' slots, their fills, the statements."""
        for b in plan:
            if b.meta.name in self.section_writes:
                cur = f"gt_slot(k, {b.ring})" if b.ring > 1 else "0"
                self.emit(f"const int {b.meta.var}_cur = {cur};")
        inits = [b for b in plan if sid in b.init]
        for b in inits:
            self._emit_plane_fill(
                b, TILED_THREADS, level=True, slot=f"{b.meta.var}_cur", kernel=self.loop
            )
        if inits:
            self.emit("__syncthreads();")
        self._emit_statements(sec, (TL_TI, TL_TJ), TILED_THREADS, [])

    def _emit_tile_wait(self, n: int, items: list[_Item]) -> None:
        """Cooperative tiled loop: the tile's origin and ownership, then
        thread 0 waits until every tile that the level's reads of earlier
        levels reach has published the level before (its counter), and the
        block follows it through a barrier."""
        written = {w.name for it in items for w in it.writes}
        span = {"i": [0, 0], "j": [0, 0]}
        for it in items:
            for r in it.reads:
                if r.name in written and _is_k_shift(r):
                    for ax, d, size in (("i", 0, TL_TI), ("j", 1, TL_TJ)):
                        lo = getattr(it.ext, ax)[0] + r.offset[d]
                        hi = getattr(it.ext, ax)[1] + r.offset[d]
                        span[ax][0] = min(span[ax][0], lo // size)
                        span[ax][1] = max(span[ax][1], (size - 1 + hi) // size)
        self.emit("const long long gt_tr = gt_t / gt_tj, gt_tc = gt_t % gt_tj;")
        self.emit(f"const long long i0 = gt_tr * {TL_TI}, j0 = gt_tc * {TL_TJ};")
        self._emit_ownership(TL_TI, TL_TJ)
        (ia, ib), (ja, jb) = span["i"], span["j"]
        with self._block("if (tid == 0 && gt_step > 0)"):
            with self._block(
                f"for (long long gt_u = gt_imax(gt_tr + ({ia}), 0); "
                f"gt_u <= gt_imin(gt_tr + ({ib}), gt_ti - 1); ++gt_u)"
            ):
                with self._block(
                    f"for (long long gt_v = gt_imax(gt_tc + ({ja}), 0); "
                    f"gt_v <= gt_imin(gt_tc + ({jb}), gt_tj - 1); ++gt_v)"
                ):
                    self.emit("const int* const gt_f = gt_flags + gt_u * gt_tj + gt_v;")
                    self.emit("long long gt_n = 0;")
                    self.emit(
                        f"while (gt_flag_load(gt_f) < gt_step) if (++gt_n > {SPIN_POLLS}LL) __trap();"
                    )
        self.emit("__syncthreads();")

    def _flat_index(self, node: gtir.FieldAccess, m: FieldMeta) -> str:
        """Row-major element index of a data-dimension access; per-point
        indices are clamped to the dimension, as the plain version clips
        them."""
        terms, stride = [], 1
        for d in reversed(range(len(m.data_dims))):
            e = node.data_index[d]
            if isinstance(e, gtir.Literal):
                idx = f"{int(e.value)}LL"
            else:
                idx = f"gt_clampk((long long)({self._expr(e)}), {m.data_dims[d]})"
            terms.append(f"{idx} * {stride}")
            stride *= m.data_dims[d]
        return "(" + " + ".join(reversed(terms)) + ")" if terms else "0"

    def _buffer_access(self, node: gtir.FieldAccess) -> Optional[str]:
        """A read or write of a symbol held in shared memory, or None where
        a tiled block must read device memory instead: a level its ring does
        not hold, or a read the input ring does not serve."""
        b = self.buffers[node.name]
        m, v = b.meta, b.meta.var
        if b.kind == "table":
            return f"{v}_s[{self._flat_index(node, m)}]"
        di, dj, dk = node.offset
        point = f"{v}_x + ({di * b.cols + dj})"

        def at(slot: Optional[str]) -> str:
            e = point if slot is None else f"{slot} * {b.plane} + {point}"
            if b.nd > 1:
                e = f"({e}) * {b.nd} + {self._flat_index(node, m)}"
            return f"{v}_s[{e}]"

        if b.kind == "input":
            if (node.name, node.offset) not in self.ring_reads:
                return None
            half = _HALF_TYPES.get(_np_dtype(m.dtype))  # a raw element (plane's _r)
            e = at(f"gt_slot(k + ({dk}), {b.ring})")
            return f"{half[1]}({half[3]}({e}))" if half else e
        if b.kind == "staged" or self.strategy in ("fused_plane", "plane"):
            return at(None)
        if dk == 0:
            return at(f"{v}_cur") if node.name in self.section_writes else None
        if self.loop in self.cooperative:
            return None  # device memory: the tiles it reaches have published it
        level = f"(k + ({dk}))"
        slot = at(f"gt_slot({level}, {b.ring})")
        if self.item is not None and self._ring_holds(self.loop, b, self.item.interval, dk):
            return slot
        held = " || ".join(
            f"({level} >= {self._k_bound(iv.start)} && {level} < {self._k_bound(iv.end)})"
            for sid, iv in self.loop_sections
            if sid in b.writers
        )
        return f"(({held or '0'}) ? {slot} : {self._global_access(node)})"

    def _emit_buffered_assign(self, stmt: gtir.Assign) -> None:
        """plane, fused_plane and tiled: store to the shared plane (all
        computed points) and to device memory at the points the block
        owns."""
        t = stmt.target
        m = self._meta(t.name)
        ct = _ctype(m.dtype)
        b = self.buffers.get(t.name)
        own = self.item is not None and self.item.wide
        if t.koffset is not None:
            kt = f"({m.var}_ok + k + ({t.offset[2]}) + (long long)({self._expr(t.koffset)}))"
            cond = f"{kt} >= 0 && {kt} < {m.var}_nk" + (" && gt_own" if own else "")
            if stmt.mask is not None:
                cond = f"({self._expr(stmt.mask)}) && ({cond})"
            store = self._global_store(t, self._expr(stmt.value), k_override=kt)
            self.emit(f"if ({cond}) {{ {store} }}")
            return
        stores = []
        if b is not None and b.kind == "shared":
            stores.append(f"{self._buffer_access(t)} = gt_v;")
        if t.name in self.carries:
            stores.append(f"{m.var}_r = gt_v;")
        if not m.is_temp or (self.strategy == "tiled" and t.name not in self.no_buffer):
            g = self._global_store(t, "gt_v")
            stores.append(f"if (gt_own) {g}" if own else g)
        body = f"{{ const {ct} gt_v = {self._expr(stmt.value)}; {' '.join(stores)} }}"
        if stmt.mask is None:
            self.emit(body)
        else:
            self.emit(f"if ({self._expr(stmt.mask)}) {body}")

    # -- per-point addresses ---------------------------------------------------

    def _emit_field_base(self, m: FieldMeta, *, with_k: bool) -> None:
        """``char* v_b``: the field's address at (i, j), and at k too when
        ``with_k``; an access then adds only its constant offsets."""
        v = m.var
        terms = [
            f"({v}_o{r} + {r}) * {v}_s{r}"
            for r, present in zip("ijk", m.axes)
            if present and (r != "k" or with_k)
        ]
        self.emit(f"char* const {v}_b = {' + '.join([v] + terms)};")
        self.point_base[m.name] = f"{v}_b"

    # -- statements ------------------------------------------------------------

    def _region_cond(self, hmasks) -> str:
        """Point-in-all-regions condition (c_codegen._region_cond)."""
        terms = []
        for hm in hmasks:
            for var, interval, size in (("i", hm.i, "ni"), ("j", hm.j, "nj")):
                for b, cmp_ in ((interval.start, ">="), (interval.end, "<")):
                    if b is None:
                        continue
                    if b.level == gtir.LevelMarker.START:
                        bound = str(b.offset)
                    else:
                        bound = f"{size} + ({b.offset})"
                    terms.append(f"({var} {cmp_} {bound})")
        return " && ".join(terms) if terms else "1"

    def _emit_stmt(self, stmt: gtir.Stmt) -> None:
        hmasks = getattr(stmt, "horizontal_masks", ())
        if hmasks:
            with self._block(f"if ({self._region_cond(hmasks)})"):
                self._emit_stmt_body(stmt)
        else:
            self._emit_stmt_body(stmt)

    def _emit_stmt_body(self, stmt: gtir.Stmt) -> None:
        if isinstance(stmt, gtir.Assign):
            self._emit_assign(stmt)
        elif isinstance(stmt, gtir.While):
            cond = self._expr(stmt.cond)
            if stmt.mask is not None:
                cond = f"({self._expr(stmt.mask)}) && ({cond})"
            with self._block(f"while ({cond})"):
                for s in stmt.body:
                    if not isinstance(s, gtir.Assign):
                        raise CudaUnsupported(f"{type(s).__name__} inside while body")
                    self._emit_assign(s)
        else:
            raise CudaUnsupported(f"statement {type(stmt).__name__}")

    def _emit_assign(self, stmt: gtir.Assign) -> None:
        if self.strategy in ("plane", "fused_plane", "tiled"):
            self._emit_buffered_assign(stmt)
            return
        if stmt.target.name in self.held:
            self._emit_held_assign(stmt, self.held[stmt.target.name])
            return
        t = stmt.target
        if t.koffset is not None:
            # Variable-K-offset write: out-of-range target levels are
            # DROPPED (a clamp would smear onto the boundary level).
            m = self._meta(t.name)
            kt = f"({m.var}_ok + k + ({t.offset[2]}) + (long long)({self._expr(t.koffset)}))"
            cond = f"{kt} >= 0 && {kt} < {m.var}_nk"
            if stmt.mask is not None:
                cond = f"({self._expr(stmt.mask)}) && ({cond})"
            store = self._global_store(t, self._expr(stmt.value), k_override=kt)
            self.emit(f"if ({cond}) {{ {store} }}")
            return
        store = self._global_store(stmt.target, self._expr(stmt.value))
        if stmt.mask is None:
            self.emit(store)
        else:
            self.emit(f"if ({self._expr(stmt.mask)}) {{ {store} }}")

    # -- expressions -------------------------------------------------------------

    def _meta(self, name: str) -> FieldMeta:
        m = self.fields.get(name)
        if m is None:
            raise CudaUnsupported(f"access to unknown symbol '{name}'")
        return m

    def _access(self, node: gtir.FieldAccess, *, k_override: str = "") -> str:
        if self.patch_point is not None:  # plane's _r kernel: a register
            pi, pj = self.patch_point
            return self._reg(
                self._meta(node.name).var, self._patch_source(self.item, node),
                pi + node.offset[0], pj + node.offset[1],
            )
        if node.name in self.held:
            held = self._held_access(node)
            if held is not None:
                return held
        if (
            self.ring is not None
            and (node.name, node.offset) in self.ring_reads
            and node.koffset is None
            and node.abs_k is None
            and not node.data_index
        ):
            return self._ring_access(node)
        if node.name in self.carries and _is_carry(
            self.carries, node, self.stencil.vertical_loops[self.loop].loop_order
            == gtir.LoopOrder.BACKWARD
        ):
            return f"{self.fields[node.name].var}_r{abs(node.offset[2])}"
        if node.name in self.buffers:
            held = self._buffer_access(node)
            if held is not None:
                return held
        if node.name in self.coherent:
            return self._global_access(node, k_override=k_override, load="__ldcg")
        return self._global_access(node, k_override=k_override)

    def _global_access(
        self, node: gtir.FieldAccess, *, k_override: str = "", load: str = ""
    ) -> str:
        """A read of the symbol in device memory, in its compute type;
        ``load``: through this intrinsic (``__ldcg``: from L2)."""
        m = self._meta(node.name)
        addr = self._global_address(node, k_override)
        return _load(m, addr, load, const=m.name in self.read_only)

    def _global_store(self, node: gtir.FieldAccess, value: str, *, k_override: str = "") -> str:
        """The statement storing ``value`` (of the compute type) to the
        symbol in device memory; a half field rounds it to nearest even."""
        m = self._meta(node.name)
        addr = self._global_address(node, k_override)
        half = _HALF_TYPES.get(_np_dtype(m.dtype))
        if half:
            return f"*({half[0]}*)({addr}) = {half[2]}({value});"
        return f"(*({_ctype(m.dtype)}*)({addr})) = {value};"

    def _global_address(self, node: gtir.FieldAccess, k_override: str = "") -> str:
        """The byte address of the symbol's element in device memory."""
        m = self._meta(node.name)
        v = m.var
        di, dj, dk = node.offset
        base = self.point_base.get(m.name)
        terms = []
        if base is None:  # column kernel: the full (i, j) address per access
            base = v
            if m.axes[0]:
                terms.append(f"({v}_oi + i + ({di})) * {v}_si")
            if m.axes[1]:
                terms.append(f"({v}_oj + j + ({dj})) * {v}_sj")
        else:  # tile kernels: constant offsets from the point's address
            # (plane: 32-bit strides, which the wrapper checks)
            narrow = "4" if self.strategy == "plane" else ""
            if m.axes[0] and di:
                terms.append(f"({di}) * {v}_si{narrow}")
            if m.axes[1] and dj:
                terms.append(f"({dj}) * {v}_sj{narrow}")
        if m.axes[2] and self.strategy in ("column", "fused_column", "tiled"):
            if k_override:
                terms.append(f"{k_override} * {v}_sk")
            elif node.abs_k is not None:
                kexpr = f"{v}_ok + (long long)({self._expr(node.abs_k)})"
                terms.append(f"gt_clampk({kexpr}, {v}_nk) * {v}_sk")
            elif node.koffset is not None:
                kexpr = f"{v}_ok + k + ({dk}) + (long long)({self._expr(node.koffset)})"
                terms.append(f"gt_clampk({kexpr}, {v}_nk) * {v}_sk")
            elif dk:
                terms.append(f"gt_clampk({v}_ok + k + ({dk}), {v}_nk) * {v}_sk")
            else:
                terms.append(f"({v}_ok + k) * {v}_sk")
        elif m.axes[2] and (dk or node.koffset is not None or node.abs_k is not None):
            raise CudaUnsupported(f"K-offset read of '{m.name}' in the plane kernel")
        for d, e in enumerate(node.data_index):
            idx = f"(long long)({self._expr(e)})"
            if not isinstance(e, gtir.Literal):  # clipped, as the plain version does
                idx = f"gt_clampk({idx}, {m.data_dims[d]})"
            terms.append(f"({idx}) * {v}_d{d}")
        return " + ".join([base] + terms)

    def _expr(self, node: gtir.Expr) -> str:
        if isinstance(node, gtir.Literal):
            return self._literal(node.value, _np_dtype(node.dtype))
        if isinstance(node, gtir.ScalarAccess):
            var = self.scalar_vars.get(node.name)
            if var is None:
                raise CudaUnsupported(f"scalar '{node.name}' is not a parameter")
            return var
        if isinstance(node, gtir.FieldAccess):
            return self._access(node)
        if isinstance(node, gtir.UnaryOp):
            inner = self._expr(node.expr)
            if node.op == gtir.UnaryOperator.NOT:
                return f"(!({inner}))"
            if node.op == gtir.UnaryOperator.NEG:
                return f"(-({inner}))"
            return f"(+({inner}))"
        if isinstance(node, gtir.BinaryOp):
            return self._binop(node)
        if isinstance(node, gtir.TernaryOp):
            ct = _ctype(node.dtype)
            return (
                f"(({self._expr(node.cond)}) ? ({ct})({self._expr(node.true_expr)})"
                f" : ({ct})({self._expr(node.false_expr)}))"
            )
        if isinstance(node, gtir.NativeFuncCall):
            return self._call(node)
        if isinstance(node, gtir.Cast):
            ct = _ctype(node.dtype)
            inner = self._expr(node.expr)
            if _np_dtype(node.dtype) == _BOOL:
                return f"((unsigned char)(({inner}) != 0))"
            return f"(({ct})({inner}))"
        if isinstance(node, gtir.IteratorAccess):
            dt = node.dtype if node.dtype is not None else np.dtype(np.int64)
            return f"(({_ctype(dt)})k)"
        raise CudaUnsupported(f"expression {type(node).__name__}")

    def _literal(self, value: Any, dtype: np.dtype) -> str:
        ct = _ctype(dtype)
        if dtype.kind == "b":
            return "1" if value else "0"
        if dtype.kind in "iu":
            return f"(({ct})({int(value)}LL))"
        v = float(value)
        f32 = _is_f32(dtype)
        if math.isnan(v):
            return "__int_as_float(0x7fc00000)" if f32 else "__longlong_as_double(0x7ff8000000000000LL)"
        if math.isinf(v):
            sign = "-" if v < 0 else ""
            inf = "__int_as_float(0x7f800000)" if f32 else "__longlong_as_double(0x7ff0000000000000LL)"
            return f"({sign}{inf})"
        if f32:
            return f"({float(np.float32(v))!r}f)"
        return f"(({ct})({v!r}))"

    def _binop(self, node: gtir.BinaryOp) -> str:
        op = node.op
        left, right = self._expr(node.left), self._expr(node.right)
        A, C, L = (
            gtir.ArithmeticOperator,
            gtir.ComparisonOperator,
            gtir.LogicalOperator,
        )
        if isinstance(op, L):
            c_op = "&&" if op == L.AND else "||"
            return f"(({left}) {c_op} ({right}))"
        if isinstance(op, C):
            prom = comparison_dtype(
                getattr(node.left, "dtype", None), getattr(node.right, "dtype", None)
            )
            pct = _ctype(prom) if prom is not None else "double"
            return f"((unsigned char)((({pct})({left})) {op.value} (({pct})({right}))))"
        dt = _np_dtype(node.dtype)
        ct = _ctype(dt)
        lc, rc = f"(({ct})({left}))", f"(({ct})({right}))"
        if dt == _BOOL:
            # NumPy bool arithmetic: + is logical-or, * is logical-and.
            if op == A.ADD:
                return f"((unsigned char)(({left}) || ({right})))"
            if op == A.MUL:
                return f"((unsigned char)(({left}) && ({right})))"
            raise CudaUnsupported(f"bool operands for '{op.value}'")
        if op in (A.ADD, A.SUB, A.MUL, A.DIV):
            return f"({lc} {op.value} {rc})"
        if op == A.MOD:
            if dt.kind in "iu":
                return f"(({ct})gt_imod_np((int64_t){lc}, (int64_t){rc}))"
            fn = "gt_fmodf_np" if _is_f32(dt) else "gt_fmod_np"
            return f"{fn}({lc}, {rc})"
        if op == A.POW:
            if dt.kind in "iu":
                return f"(({ct})gt_ipow((int64_t){lc}, (int64_t){rc}))"
            fn = "powf" if _is_f32(dt) else "pow"
            return f"{fn}({lc}, {rc})"
        raise CudaUnsupported(f"operator '{op.value}'")

    def _call(self, node: gtir.NativeFuncCall) -> str:
        F = gtir.NativeFunction
        dt = _np_dtype(node.dtype)
        args = [self._expr(a) for a in node.args]
        if node.func in (F.ISFINITE, F.ISINF, F.ISNAN):
            return f"((unsigned char)({node.func.value}((double)({args[0]})) != 0))"
        ct = _ctype(dt)
        cast_args = [f"(({ct})({a}))" for a in args]
        if dt.kind in "iub":
            if node.func == F.ABS:
                if dt.kind in "ub":
                    return cast_args[0]
                return f"(({ct})llabs((long long){cast_args[0]}))"
            if node.func in (F.MIN, F.MAX):
                fn = "gt_imin" if node.func == F.MIN else "gt_imax"
                return f"(({ct}){fn}((int64_t){cast_args[0]}, (int64_t){cast_args[1]}))"
            if node.func == F.MOD:
                return (
                    f"(({ct})gt_imod_np((int64_t){cast_args[0]}, (int64_t){cast_args[1]}))"
                )
            if node.func == F.POW:
                return f"(({ct})gt_ipow((int64_t){cast_args[0]}, (int64_t){cast_args[1]}))"
            if node.func in (F.FLOOR, F.CEIL, F.TRUNC, F.ROUND, F.ROUND_AWAY_FROM_ZERO):
                return cast_args[0]  # integral already
            raise CudaUnsupported(f"integer-typed call to {node.func.value}")
        f32 = _is_f32(dt)
        if node.func == F.ABS:
            return f"({'fabsf' if f32 else 'fabs'}({cast_args[0]}))"
        if node.func in (F.MIN, F.MAX):
            base = "gt_fmin" if node.func == F.MIN else "gt_fmax"
            fn = f"{base}f_np" if f32 else f"{base}_np"
            return f"{fn}({cast_args[0]}, {cast_args[1]})"
        if node.func == F.MOD:
            fn = "gt_fmodf_np" if f32 else "gt_fmod_np"
            return f"{fn}({cast_args[0]}, {cast_args[1]})"
        libm = _LIBM.get(node.func)
        if libm is None:
            raise CudaUnsupported(f"native function {node.func.value}")
        fn = libm + "f" if f32 else libm
        return f"{fn}({', '.join(cast_args)})"


__all__ = [
    "COL_BI",
    "COL_BJ",
    "CudaUnsupported",
    "FieldMeta",
    "KernelModule",
    "TI",
    "TJ",
    "generate",
]
