"""Dispatchers for the fused-gate and diagonal/permutation CUDA kernels.

Each wrapper takes its plain version (``ref.py``) for a tensor on the CPU
and launches its kernel for a tensor on a CUDA device; anything else, or a
tensor the kernel does not take, raises.  There is no fallback from a CUDA
tensor to the plain version.  Both wrappers accept an optional leading batch
axis on the state, and a batch extent of 1 or B on the unitary / phase
planes (1 broadcasts).

The launch plans (:func:`fused_plan`, :func:`phase_plan`) are worked out
here, in plain Python, and handed to the kernels as a packed int64 array:
the cut ``s`` that splits the amplitude index into a tile-local part and a
tile number, the bit runs the kernels scatter and gather with, and the
order in which a tile's groups are dealt to threads.  The CPU tests replay
a plan index by index against the plain versions.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build as KB
from repro_torch.kernels.apply_gate import ref as R

MAX_K = 7          # widest dense gate the fused kernel takes (U in shared memory)

FUSED = KB.Kernel("apply_gate", "rt_apply_fused_gate",
                  [KB.P, KB.P, KB.P, KB.P, KB.I32, KB.I32, KB.P, KB.P])
PHASE = KB.Kernel("phase_gate", "rt_apply_phase_gate",
                  [KB.P, KB.P, KB.P, KB.P, KB.I32, KB.P, KB.I32, KB.P, KB.P])

# -- launch plans ----------------------------------------------------------------
# Shared with csrc/apply_gate.cu and csrc/phase_gate.cu: the packed layouts
# below, the tile sizes and the per-k register tiles must agree with them.

FUSED_TILE_LOG = 12    # K1 tile: 2**12 amplitudes (32 KB with both planes)
PHASE_TILE_LOG = 13    # K2 gather tile: 2**13 amplitudes (64 KB)
SLICE_LOG = 12         # K2 phase slice staged per work item: 2**12 entries
ITEM_LOG = 18          # K2 streaming work item: about 2**18 amplitudes
ITEM_SPANS_LOG = 8     # K2 streaming work item: at most 2**8 spans
SPAN_LOG_MAX = 24      # K2 streaming span: offsets inside it fit 32 bits
MAX_RUNS = 32          # bit runs a packed mask may have
MAX_GBITS = 16         # K1 group-index bits (s - L <= FUSED_TILE_LOG)
# K1 register tile per gate width k: (rows of U, groups) per thread; 256
# threads x rows x groups = 2**FUSED_TILE_LOG outputs per tile pass.
FUSED_REG_TILE = {1: (2, 8), 2: (4, 4), 3: (4, 4), 4: (4, 4), 5: (4, 4),
                  6: (8, 2), 7: (8, 2)}
PHASE_STREAM, PHASE_TILE, PHASE_DIRECT = 0, 1, 2


def bit_runs(mask: int) -> list[tuple[int, int, int]]:
    """Runs of consecutive set bits of ``mask`` as ``(lowest bit, length,
    rank of the lowest bit among the set bits)``, ascending."""
    runs, rank, b = [], 0, 0
    while mask >> b:
        if (mask >> b) & 1:
            lo = b
            while (mask >> b) & 1:
                b += 1
            runs.append((lo, b - lo, rank))
            rank += b - lo
        else:
            b += 1
    return runs


def pdep(x: int, runs) -> int:
    """Scatter the low bits of ``x`` to the positions of ``runs``."""
    out = 0
    for lo, ln, off in runs:
        out |= ((x >> off) & ((1 << ln) - 1)) << lo
    return out


def pext(x: int, runs) -> int:
    """Gather the bits of ``x`` at the positions of ``runs``."""
    out = 0
    for lo, ln, off in runs:
        out |= ((x >> lo) & ((1 << ln) - 1)) << off
    return out


def swizzle(a: int) -> int:
    """K1's shared-memory swizzle: the 16-byte chunk index (word bits 2-4)
    XOR the 128-byte row index (bits 5-7).  Linear over XOR and it keeps
    each 16-byte chunk whole, so ``cp.async`` can fill the tile."""
    return a ^ (((a >> 5) & 7) << 2)


def _bank_vector(bit: int) -> int:
    """The bank bits (word bits 0-4 after :func:`swizzle`) that flipping
    tile-offset bit ``bit`` flips."""
    if bit < 5:
        return 1 << bit
    if bit < 8:
        return 1 << (bit - 3)
    return 0


def _pack_runs(runs) -> list[int]:
    if len(runs) > MAX_RUNS:
        raise ValueError(f"{len(runs)} bit runs exceed {MAX_RUNS}")
    flat = [0] * (3 * MAX_RUNS)
    for i, (lo, ln, off) in enumerate(runs):
        flat[i], flat[MAX_RUNS + i], flat[2 * MAX_RUNS + i] = lo, ln, off
    return [len(runs)] + flat


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """K1 launch plan.  A tile is the ``2**h`` spans of ``2**s`` contiguous
    amplitudes that the gate bits at or above ``s`` select; the tile number
    scatters to the free bits at or above ``s`` (``tile_runs``).  Tile-local
    offset ``j * 2**s + o`` holds amplitude ``tile base + span_off[j] + o``.
    Group ``gi`` of a tile scatters to ``gbits``; row ``r`` of U adds
    ``row_off[r]``.  Thread ``u`` takes rows ``(u % rb) * tr + i`` of groups
    ``(u // rb) * tg + j``.  Controls below ``s`` mask groups, controls at
    or above it mask whole tiles."""
    n: int
    qubits: tuple[int, ...]
    s: int
    low: int                   # gate bits below s
    tr: int
    tg: int
    tile_runs: tuple
    gbits: tuple[int, ...]
    cmask_lo: int
    cmask_hi: int

    @property
    def k(self) -> int:
        return len(self.qubits)

    @property
    def h(self) -> int:
        return self.k - self.low

    @property
    def tiles_per_row(self) -> int:
        return 1 << (self.n - self.s - self.h)

    @property
    def groups(self) -> int:
        return 1 << (self.s - self.low)

    @property
    def rb(self) -> int:
        return (1 << self.k) // self.tr

    @property
    def units(self) -> int:
        return self.rb * -(-self.groups // self.tg)

    def span_off(self, j: int) -> int:
        out = 0
        for m, q in enumerate(self.qubits[self.low:]):
            out |= ((j >> m) & 1) << q
        return out

    def row_off(self, r: int) -> int:
        out = (r >> self.low) << self.s
        for m, q in enumerate(self.qubits[:self.low]):
            out |= ((r >> m) & 1) << q
        return out

    def group_base(self, gi: int) -> int:
        out = 0
        for i, b in enumerate(self.gbits):
            out |= ((gi >> i) & 1) << b
        return out

    def tile_base(self, t: int) -> int:
        return pdep(t, self.tile_runs)

    def global_index(self, t: int, local: int) -> int:
        j, o = local >> self.s, local & ((1 << self.s) - 1)
        return self.tile_base(t) + self.span_off(j) + o

    def pack(self) -> np.ndarray:
        head = [self.n, self.k, self.s, self.low, self.tr, self.tg,
                self.cmask_lo, self.cmask_hi, len(self.gbits)]
        q = list(self.qubits) + [0] * (8 - self.k)
        g = list(self.gbits) + [0] * (MAX_GBITS - len(self.gbits))
        return np.asarray(head + q + g + _pack_runs(self.tile_runs),
                          np.int64)


@functools.lru_cache(maxsize=4096)
def fused_plan(n: int, qubits: tuple[int, ...],
               controls: tuple[int, ...] = ()) -> FusedPlan:
    """Plan K1 for sorted gate ``qubits`` on an ``n``-qubit state.

    The cut ``s`` is the largest with ``s + (gate bits >= s) <=
    FUSED_TILE_LOG``, so a tile holds at most 2**12 amplitudes and every
    global access is a run of ``2**s`` contiguous ones.  The group bits
    that vary across a warp's lanes are picked so that the swizzled
    addresses of one column fall in distinct banks where the placement
    allows it."""
    k = len(qubits)
    gset = set(qubits)
    s = max(c for c in range(n + 1)
            if c + sum(q >= c for q in qubits) <= FUSED_TILE_LOG)
    low = sum(q < s for q in qubits)
    tr, tg = FUSED_REG_TILE[k]
    rb = (1 << k) // tr
    lane_bits = max(0, 5 - (rb.bit_length() - 1))
    free_lo = [b for b in range(s) if b not in gset]
    lg_tg = tg.bit_length() - 1
    # lane bits: greedily independent bank vectors, lowest first
    lanes, basis = [], []
    for b in free_lo:
        if len(lanes) == lane_bits:
            break
        v = _bank_vector(b)
        for e in basis:
            v = min(v, v ^ e)
        if v:
            basis.append(v)
            lanes.append(b)
    rest = [b for b in free_lo if b not in lanes]
    while len(lanes) < lane_bits and len(rest) > lg_tg:
        lanes.append(rest.pop(lg_tg))
    gbits = tuple(rest[:lg_tg] + lanes + rest[lg_tg:])
    free_hi = sum(1 << b for b in range(s, n) if b not in gset)
    cmask = sum(1 << c for c in controls)
    lo_mask = (1 << s) - 1
    return FusedPlan(n=n, qubits=tuple(qubits), s=s, low=low, tr=tr, tg=tg,
                     tile_runs=tuple(bit_runs(free_hi)), gbits=gbits,
                     cmask_lo=cmask & lo_mask, cmask_hi=cmask & ~lo_mask)


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """K2 launch plan, in one of three modes.

    ``PHASE_STREAM`` (no permutation): a work item fixes the batch row, the
    cluster bits at or above ``s`` (``hc``, scattered by ``hi_runs``) and
    the top free bits at or above ``s``; it stages the ``2**w_low`` phase
    entries its spans need (``phase[hc * 2**w_low:][:2**w_low]``) once and
    streams ``2**m`` spans of ``2**s`` amplitudes past them, the span's
    free bits scattered by ``free_runs``.  ``PHASE_TILE`` (a permutation
    that touches bits below ``s``): a tile is the ``2**h`` spans that the
    cluster bits at or above ``s`` select, at one value of the free bits;
    it is staged in shared memory and gathered from there.
    ``PHASE_DIRECT`` (a pure phase on a cluster that runs up to the top
    bit, a permutation whose cluster has no bits below ``s``, or one too
    wide for a tile): a flat pass in which every 4-amplitude chunk reads
    its phase entry and gathers its source from global memory, whole
    chunks when the lowest cluster bit is at least 2.  ``low_runs`` gather the cluster bits below
    ``s`` of a tile-local offset; ``all_runs`` those of a full index."""
    mode: int
    n: int
    w: int
    s: int
    m: int
    low_runs: tuple
    hi_runs: tuple
    free_runs: tuple
    all_runs: tuple

    @property
    def w_low(self) -> int:
        return sum(ln for _, ln, _ in self.low_runs)

    @property
    def h(self) -> int:
        return self.w - self.w_low

    @property
    def nfree_hi(self) -> int:
        return self.n - self.s - self.h

    @property
    def items_per_row(self) -> int:
        if self.mode == PHASE_STREAM:
            return 1 << (self.h + self.nfree_hi - self.m)
        if self.mode == PHASE_TILE:
            return 1 << self.nfree_hi
        return 1 << max(0, self.n - 2)

    def pack(self) -> np.ndarray:
        head = [self.mode, self.n, self.w, self.s, self.m]
        body = []
        for runs in (self.low_runs, self.hi_runs, self.free_runs,
                     self.all_runs):
            body += _pack_runs(runs)
        return np.asarray(head + body, np.int64)


@functools.lru_cache(maxsize=4096)
def phase_plan(n: int, qubits: tuple[int, ...], perm: bool) -> PhasePlan:
    """Plan K2 for sorted cluster ``qubits`` on an ``n``-qubit state."""
    w = len(qubits)
    cmask = sum(1 << q for q in qubits)

    def low_count(c):
        return sum(q < c for q in qubits)

    top_run = cmask == ((1 << n) - 1) & ~((1 << qubits[0]) - 1)
    if n < 2:
        mode, s = PHASE_DIRECT, n
    elif not perm and top_run:
        # bits c..n-1: a flat pass meets each entry once, in order
        mode, s = PHASE_DIRECT, 2
    elif not perm:
        # largest cut whose phase slice fits, but no wider than needed
        s = max(c for c in range(min(n, SPAN_LOG_MAX) + 1)
                if low_count(c) <= SLICE_LOG)
        need = qubits[low_count(s) - 1] + 1 if low_count(s) else 0
        s = min(s, max(need, min(n, SLICE_LOG)))
        mode = PHASE_STREAM
    else:
        fits = [c for c in range(2, n + 1)
                if c + (w - low_count(c)) <= PHASE_TILE_LOG]
        s = max(fits) if fits else 0
        mode = PHASE_TILE
        if not fits or low_count(s) == 0:
            mode, s = PHASE_DIRECT, 2
    lo_mask = (1 << s) - 1
    hi_mask = cmask & ~lo_mask
    free_hi = ((1 << n) - 1) & ~lo_mask & ~cmask
    nfree = bin(free_hi).count("1")
    m = 0
    if mode == PHASE_STREAM:
        m = min(nfree, max(0, ITEM_LOG - s), ITEM_SPANS_LOG)
    return PhasePlan(mode=mode, n=n, w=w, s=s, m=m,
                     low_runs=tuple(bit_runs(cmask & lo_mask)),
                     hi_runs=tuple(bit_runs(hi_mask)),
                     free_runs=tuple(bit_runs(free_hi)),
                     all_runs=tuple(bit_runs(cmask)))


@functools.lru_cache(maxsize=4096)
def _packed(plan) -> np.ndarray:
    return plan.pack()


@functools.lru_cache(maxsize=1024)
def _sort_perm(qubits: tuple[int, ...]) -> tuple[tuple[int, ...], np.ndarray]:
    """Permutation taking U (bit m <-> qubits[m]) to sorted-qubit order."""
    qs_sorted = tuple(sorted(qubits))
    pos = {q: m for m, q in enumerate(qubits)}
    k = len(qubits)
    perm = np.zeros(1 << k, np.int32)
    for j in range(1 << k):
        j_orig = 0
        for m in range(k):
            if (j >> m) & 1:
                j_orig |= 1 << pos[qs_sorted[m]]
        perm[j] = j_orig
    return qs_sorted, perm


def _mask(qubits, n: int, what: str) -> int:
    m = 0
    for q in qubits:
        if not 0 <= q < n or (m >> q) & 1:
            raise ValueError(f"{what} {tuple(qubits)} invalid for n={n}")
        m |= 1 << q
    return m


def _check_state(data: torch.Tensor, n: int, v: int) -> int:
    """Validate a CUDA planar state; returns its batch extent."""
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("state must be a contiguous float32 tensor")
    if data.dim() not in (3, 4) or tuple(data.shape[-3:]) != (
            2, 1 << (n - v), 1 << v):
        raise ValueError(f"state shape {tuple(data.shape)} is not "
                         f"[B,] 2 x {1 << (n - v)} x {1 << v}")
    b = data.shape[0] if data.dim() == 4 else 1
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernels' grid limit 65535")
    return b


def _check_rows(t: torch.Tensor, like: torch.Tensor, b: int,
                tail: tuple[int, ...], what: str) -> int:
    """Validate per-row operands ([*tail] or [1|B, *tail]); returns 1 if
    they are batched per row, else 0."""
    if t.device != like.device or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous float32 on {like.device}")
    if tuple(t.shape) == tail:
        return 0
    if t.dim() == len(tail) + 1 and tuple(t.shape[1:]) == tail \
            and t.shape[0] in (1, b):
        return int(t.shape[0] != 1)
    raise ValueError(f"{what} shape {tuple(t.shape)} is not [1|{b},] {tail}")


def apply_fused_gate(data: torch.Tensor, n: int, v: int,
                     qubits: tuple[int, ...], u_re: torch.Tensor,
                     u_im: torch.Tensor,
                     controls: tuple[int, ...] = ()) -> torch.Tensor:
    """Apply a (fused, optionally controlled) gate to the planar state.

    data: f32[2, R, V] or f32[B, 2, R, V] lane-tiled planar state.
    qubits: target qubit ids; bit m of u's index <-> qubits[m].
    u_re/u_im: f32[2**k, 2**k] or f32[1|B, 2**k, 2**k].
    Returns a new tensor; the input is not modified.
    """
    qubits = tuple(int(q) for q in qubits)
    controls = tuple(int(c) for c in controls)
    qs_sorted, perm = _sort_perm(qubits)
    if qs_sorted != qubits:
        p = torch.as_tensor(perm, dtype=torch.long, device=u_re.device)
        u_re = u_re[..., p, :][..., :, p]
        u_im = u_im[..., p, :][..., :, p]
    if data.device.type == "cpu":
        return R.apply_fused_gate_ref(data, n, v, qs_sorted, u_re, u_im,
                                      controls)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    k = len(qs_sorted)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused kernel takes 1..{MAX_K} gate qubits, got {k}")
    gmask = _mask(qs_sorted, n, "qubits")
    cmask = _mask(controls, n, "controls")
    if gmask & cmask:
        raise ValueError(f"qubits {qubits} overlap controls {controls}")
    b = _check_state(data, n, v)
    d = 1 << k
    u_re, u_im = u_re.contiguous(), u_im.contiguous()
    batched = _check_rows(u_re, data, b, (d, d), "u_re")
    if _check_rows(u_im, data, b, (d, d), "u_im") != batched \
            or u_im.shape != u_re.shape:
        raise ValueError("u_re and u_im shapes differ")
    plan = _packed(fused_plan(n, qs_sorted, tuple(sorted(controls))))
    out = torch.empty_like(data)
    with torch.cuda.device(data.device):
        FUSED(KB.ptr(data), KB.ptr(out), KB.ptr(u_re), KB.ptr(u_im), batched,
              b, plan.ctypes.data, KB.stream_of(data))
    return out


def apply_phase_gate(data: torch.Tensor, n: int, v: int,
                     qubits: tuple[int, ...], p_re: torch.Tensor | None,
                     p_im: torch.Tensor | None, perm=None) -> torch.Tensor:
    """Apply a diagonal/permutation (monomial) fused gate to the planar state.

    data: f32[2, R, V] or f32[B, 2, R, V] lane-tiled planar state.
    qubits: sorted cluster qubit ids; bit m of the ``2**w`` phase vector /
    ``perm`` index map corresponds to ``qubits[m]``.
    p_re/p_im: f32[2**w] or f32[1|B, 2**w] phase planes (``None`` for a pure
    permutation).
    perm: optional int[2**w] index map (numpy or tensor), ``out[r] =
    phase[r] * in[perm[r]]`` over the cluster rows.
    Returns a new tensor; the input is not modified.
    """
    qubits = tuple(int(q) for q in qubits)
    if qubits != tuple(sorted(qubits)):
        raise ValueError(f"apply_phase_gate needs sorted qubits, got {qubits}")
    if (p_re is None) != (p_im is None):
        raise ValueError("pass both phase planes or neither")
    if data.device.type == "cpu":
        return R.apply_phase_gate_ref(data, n, v, qubits, p_re, p_im,
                                      perm=perm)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    w = len(qubits)
    if not 1 <= w <= 31:
        raise ValueError(f"phase kernel takes 1..31 cluster qubits, got {w}")
    _mask(qubits, n, "qubits")
    b = _check_state(data, n, v)
    batched = 0
    if p_re is not None:
        batched = _check_rows(p_re, data, b, (1 << w,), "p_re")
        if _check_rows(p_im, data, b, (1 << w,), "p_im") != batched \
                or p_im.shape != p_re.shape:
            raise ValueError("p_re and p_im shapes differ")
    perm_t = None
    if perm is not None:
        perm_t = torch.as_tensor(perm if torch.is_tensor(perm)
                                 else np.asarray(perm, np.int32),
                                 device=data.device).to(torch.int32)
        perm_t = perm_t.contiguous()
        if tuple(perm_t.shape) != (1 << w,):
            raise ValueError(f"perm shape {tuple(perm_t.shape)} is not "
                             f"({1 << w},)")
    plan = _packed(phase_plan(n, qubits, perm_t is not None))
    out = torch.empty_like(data)
    with torch.cuda.device(data.device):
        PHASE(KB.ptr(data), KB.ptr(out), KB.ptr(p_re), KB.ptr(p_im), batched,
              KB.ptr(perm_t), b, plan.ctypes.data, KB.stream_of(data))
    return out
