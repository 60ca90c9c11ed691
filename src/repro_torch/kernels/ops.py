"""Public kernel entry points, routed through the backend dispatcher.

Each wrapper names its kernel and hands the call to
:func:`repro_torch.kernels.dispatch.dispatch`, which picks one of two
backends per call: ``cuda``, the hand-written CUDA kernel (``csrc/*.cu``,
built at first use by :mod:`repro_torch.kernels.build`), or ``torch``, the
plain PyTorch version in :mod:`repro_torch.kernels.ref`.  With nothing
pinned, a CUDA tensor launches the kernel and a CPU tensor takes the plain
version; ``backend=`` (``"torch"`` | ``"cuda"``), ``policy=`` (a
:class:`KernelPolicy`) and the ``REPRO_TORCH_KERNEL_BACKEND`` variable pin
one (see the dispatcher's docstring for the order).  The block-shape
kwargs (``block_t``/``block_n``/``block_q``/``block_k``) are the JAX
package's; they default to None and reach no kernel here.  Each wrapper
also takes its kernel's launch knobs (``**knobs``, names in
``dispatch.CUDA_LAYOUT_KWARGS``; a calibration table may supply them, see
``dispatch.LAYOUT_GRIDS``): they set the ``cuda`` launch in place of the
launcher's own choice and never change what is computed; the ``torch``
backend takes none.  There is no fall-back from the card to the plain
version: a kernel that fails to build or launch raises, and so does a
launch the launcher refuses.

This module holds the ``cuda`` backend's launch code (the ``_*_cuda``
functions, which take CUDA tensors only).  ``LAUNCHES`` counts, per
kernel, the launches made in this process: the launch code adds one
exactly where it launches a kernel, so a run can show that its main path
went through the kernels (:func:`reset_launches` zeroes the counts); a
``torch`` call counts nothing, on any device.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.dispatch import KernelPolicy  # noqa: F401

F32 = torch.float32
LAUNCHES: Dict[str, int] = {"stump_scan": 0, "stump_scan_batched": 0,
                            "stump_vote_batched": 0,
                            "stump_vote_fp_batched": 0,
                            "ensemble_vote_batched": 0, "ensemble_vote": 0,
                            "dist_update": 0, "flash_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every one lies on
    one CUDA device; anything else raises."""
    return dispatch.tensors_device(tensors) == "cpu"


def _card(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device: the ``cuda``
    backend never runs the plain version."""
    if _on_cpu(*tensors):
        raise ValueError("the cuda kernel backend takes CUDA tensors; "
                         "these lie on the CPU")


def _f32(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype != F32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.contiguous()


def _knob(name: str, value, own: int) -> int:
    """A launch knob as its launcher takes it: ``own`` (the launcher's own
    choice) where the caller gave none.  A value equal to ``own`` names no
    launch and raises."""
    if value is None:
        return own
    if int(value) == own:
        raise ValueError(f"launch knob {name}={value!r} names no launch")
    return int(value)


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


_NO_SWITCH = contextlib.nullcontext()


def _on_device(t: torch.Tensor):
    """The context a launch on t's card runs in: ``torch.cuda.device``
    where that card is not the current one, else nothing (entering the
    context costs host time on every launch)."""
    dev = t.get_device()
    return _NO_SWITCH if dev == torch.cuda.current_device() \
        else torch.cuda.device(dev)


def _stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on t's device (the raw call:
    building a ``torch.cuda.Stream`` costs several µs a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# csrc/stump_scan.cu's constants: threads a block, thresholds a thread
SCAN_THREADS = 256
SCAN_CHUNK = 16
# one block a column group (one launch) while its chunks need at most this
# many rows; beyond, blocks of 8 features, two blocks an SM, and a second
# pass over the block sums
SCAN_ONE_PASS_ROWS = 8
SCAN_COLS = tuple(1 << p for p in range(9))          # 1, 2, 4, ..., 256
SCAN_MAX_BLOCKS = 512        # blocks a column group: 32 lanes of 16 sums


@functools.lru_cache(maxsize=None)
def _sms(dev: int) -> int:
    """The SM count of CUDA device ``dev``, read once."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def scan_candidate(N: int, F: int, T: int, sms: int, cols: int
                   ) -> ref.ScanSplit:
    """The split of one slot's rows over blocks of ``cols`` features (a
    power of two up to 256) on a card of ``sms`` SMs.  A block holds
    256 // cols chunks of each of its features.  One block a column group
    (one launch) where its chunks need at most ``SCAN_ONE_PASS_ROWS`` rows
    or the column groups alone give the grid two blocks an SM; else as many
    blocks a column group as give it two blocks an SM, and a second pass
    adds their sums."""
    kb = SCAN_THREADS // cols
    groups = -(-T // SCAN_CHUNK) * -(-F // cols)
    blocks = 1
    if -(-N // kb) > SCAN_ONE_PASS_ROWS:
        blocks = max(1, min(-(-2 * sms // groups), -(-N // kb),
                            SCAN_MAX_BLOCKS))
    chunks = kb * blocks
    return ref.ScanSplit(max(1, -(-N // chunks)), chunks, blocks, cols)


@functools.lru_cache(maxsize=1024)
def scan_split(N: int, F: int, T: int, sms: int) -> ref.ScanSplit:
    """How :func:`stump_scan` splits one slot's rows on a card of ``sms``
    SMs (see ``csrc/stump_scan.cu`` and :class:`ref.ScanSplit`).  Where a
    one-launch split exists (:func:`scan_candidate`), the one with the
    fewest rows a chunk, between equals the widest block; else blocks of
    8 features (a warp reads one 32-byte sector of each row of x)."""
    one_pass = [scan_candidate(N, F, T, sms, c) for c in reversed(SCAN_COLS)]
    one_pass = [s for s in one_pass if s.blocks == 1]
    if one_pass:
        return min(one_pass, key=lambda s: s.rows)
    return scan_candidate(N, F, T, sms, 8)


def scan_layout_split(N: int, F: int, T: int, sms: int,
                      cols: Optional[int] = None,
                      blocks: Optional[int] = None) -> ref.ScanSplit:
    """The split of a launch that asks for ``cols`` features a block and/or
    ``blocks`` blocks a column group (the launch knobs of
    :func:`stump_scan`): neither, :func:`scan_split`; ``cols`` alone,
    :func:`scan_candidate`'s split at that width; ``blocks`` (at ``cols``,
    else 8), 256 // cols chunks a block over that many blocks, rows enough
    to cover N.  A split the launcher cannot run is refused there."""
    if cols is None and blocks is None:
        return scan_split(N, F, T, sms)
    cols = 8 if cols is None else int(cols)
    if cols < 1:
        raise ValueError(f"stump_scan cols={cols}: need a power of two "
                         f"up to {SCAN_THREADS}")
    if blocks is None:
        return scan_candidate(N, F, T, sms, cols)
    chunks = SCAN_THREADS // cols * int(blocks)
    return ref.ScanSplit(max(1, -(-N // chunks)) if chunks > 0 else 1,
                         chunks, int(blocks), cols)


# csrc/stump_scan.cu's constants of stump_scan_batched: the row route's
# block and the split route's most blocks a column group (one cluster)
SCAN_BATCHED_THREADS = 64
SCAN_MAX_CLUSTER = 8
# the split's features a block: a warp reads one 32-byte sector of each
# row of x
SCAN_SPLIT_COLS = 8
# the batched scan splits the rows where the row route's grid leaves SMs
# idle and a row's walk takes at least this many rows
SCAN_SPLIT_MIN_ROWS = 256
# a block's tree and cluster barrier, in rows of its chunks' walk
SCAN_SPLIT_TREE_ROWS = 16
# the most (slot, chunk of 16 thresholds) pairs of the split's grid
# (gridDim.y)
SCAN_SPLIT_MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=1024)
def scan_batched_split(B: int, N: int, F: int, T: int, sms: int
                       ) -> Optional[ref.ScanSplit]:
    """How :func:`stump_scan_batched` runs on a card of ``sms`` SMs (see
    ``csrc/stump_scan.cu``): None, one thread a (b, f) row walking all N
    rows, wherever its grid of ``SCAN_BATCHED_THREADS``-thread blocks
    reaches every SM, N is short, or the split's grid would pass
    ``SCAN_SPLIT_MAX_GRID_Y`` (slot, chunk of 16 thresholds) pairs; else
    each slot's rows split over blocks of ``SCAN_SPLIT_COLS`` features,
    256 // ``SCAN_SPLIT_COLS`` chunks a block, and the blocks a column group (one cluster, 1
    to ``SCAN_MAX_CLUSTER``) whose grid ends first at two blocks an SM (its
    waves times a chunk's rows and ``SCAN_SPLIT_TREE_ROWS``), the fewest
    between equals: any size whose grid is one wave, past one wave only
    powers of two (on the H100, 7 blocks a group at 70 groups, two waves,
    ran 24% slower than 6 and 26% slower than 3, against the model's pick
    of 7).  The result fixes the order of the sum
    (:func:`ref.scan_batched_in_kernel_order`)."""
    if (-(-B * F // SCAN_BATCHED_THREADS) >= sms or N < SCAN_SPLIT_MIN_ROWS
            or B * -(-T // SCAN_CHUNK) > SCAN_SPLIT_MAX_GRID_Y):
        return None
    kb = SCAN_THREADS // SCAN_SPLIT_COLS
    groups = B * -(-F // SCAN_SPLIT_COLS) * -(-T // SCAN_CHUNK)

    def cost(G: int) -> int:
        waves = -(-groups * G // (2 * sms))
        return waves * (-(-N // (kb * G)) + SCAN_SPLIT_TREE_ROWS)

    sizes = [G for G in range(1, SCAN_MAX_CLUSTER + 1)
             if groups * G <= 2 * sms or G & (G - 1) == 0]
    G = min(sizes, key=cost)
    return ref.ScanSplit(-(-N // (kb * G)), kb * G, G, SCAN_SPLIT_COLS)


def scan_workspace(F: int, T: int, split: ref.ScanSplit) -> int:
    """Doubles of scratch a split takes: the block sums of its second pass
    (none where a column group is one block)."""
    if split.blocks == 1:
        return 0
    groups = -(-T // SCAN_CHUNK) * -(-F // split.cols)
    return split.blocks * groups * split.cols * SCAN_CHUNK


def scan_vec(T: int, *tensors: torch.Tensor) -> bool:
    """The scans' 16-byte route: T a multiple of 4 (every threshold row
    then starts 16-byte aligned) and every threshold and error tensor
    16-byte aligned; else 4-byte loads and stores."""
    return T % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _stump_scan_launch(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                       thr: torch.Tensor, split: ref.ScanSplit
                       ) -> torch.Tensor:
    """Launch ``csrc/stump_scan.cu`` on checked, contiguous f32 card
    tensors with the rows split as ``split`` says (the launcher refuses a
    split whose chunks do not cover N); returns the (F, T) errors."""
    N, F = x.shape
    T = thr.shape[1]
    err = torch.empty_like(thr)
    ws = None
    if split.blocks > 1:
        ws = torch.empty((scan_workspace(F, T, split),),
                         dtype=torch.float64, device=x.device)
    from repro_torch.kernels.build import load
    with _on_device(x):
        _launch("stump_scan", load().stump_scan_launch, x.data_ptr(),
                y.data_ptr(), w.data_ptr(), thr.data_ptr(), err.data_ptr(),
                None if ws is None else ws.data_ptr(), N, F, T, *split,
                int(scan_vec(T, thr)), _stream(x))
    return err


def stump_scan(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               thresholds: torch.Tensor, *, block_n: Optional[int] = None,
               backend: Optional[str] = None,
               policy: Optional[KernelPolicy] = None, **knobs
               ) -> torch.Tensor:
    """Weighted stump errors over the (F, T) grid: x (N,F), y/w (N,),
    thresholds (F,T) -> (F,T) f32 (see :func:`ref.stump_scan_ref`).  On
    the card the rows are split as :func:`scan_split` picks for the card's
    SM count, or as the knobs ``cols``/``blocks`` ask
    (:func:`scan_layout_split`); the sum's order is
    :func:`ref.scan_in_kernel_order`'s, in f64, so every split gives the
    plain version's bits."""
    return dispatch.dispatch("stump_scan", (x, y, w, thresholds),
                             {"block_n": block_n, **knobs}, policy=policy,
                             backend=backend)


def _stump_scan_cuda(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     thresholds: torch.Tensor, *, cols: Optional[int] = None,
                     blocks: Optional[int] = None) -> torch.Tensor:
    _card(x, y, w, thresholds)
    N, F = x.shape
    T = thresholds.shape[1]
    if y.shape != (N,) or w.shape != (N,) or thresholds.shape != (F, T):
        raise ValueError(f"stump_scan shapes x{tuple(x.shape)} "
                         f"y{tuple(y.shape)} w{tuple(w.shape)} "
                         f"thr{tuple(thresholds.shape)}")
    x, y, w = _f32("x", x), _f32("y", y), _f32("w", w)
    thr = _f32("thresholds", thresholds)
    if F * T == 0:
        return torch.empty_like(thr)
    return _stump_scan_launch(x, y, w, thr, scan_layout_split(
        N, F, T, _sms(x.get_device()), cols, blocks))


def stump_scan_batched(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                       thresholds: torch.Tensor, *,
                       block_n: Optional[int] = None,
                       backend: Optional[str] = None,
                       policy: Optional[KernelPolicy] = None, **knobs
                       ) -> torch.Tensor:
    """Per-slot weighted stump errors for a stacked fleet batch: x (B,N,F),
    y/w (B,N), thresholds (B,F,T) -> (B,F,T) f32 (see
    :func:`ref.stump_scan_batched_ref`).  Any B is launched as it is: no
    slot padding is needed.  On the card :func:`scan_batched_split` picks
    the route from the shape and the SM count: one thread a (b, f) row
    sums the rows in order, the plain version's bits; the split (where
    B·F leaves SMs idle and N is long) sums in
    :func:`ref.scan_batched_in_kernel_order`'s order, in f64, which gives
    the plain version's bits wherever every order does (the rule of
    :func:`ref.stump_scan_ref`).  Knobs: ``threads`` a block (a multiple
    of 32 up to 256) and ``depth``, the rows of a group of loads (4 in
    place of the 16-byte route's own 8), name a launch of the row route,
    which a call that gives either takes."""
    return dispatch.dispatch("stump_scan_batched", (x, y, w, thresholds),
                             {"block_n": block_n, **knobs}, policy=policy,
                             backend=backend)


def _stump_scan_batched_cuda(x: torch.Tensor, y: torch.Tensor,
                             w: torch.Tensor, thresholds: torch.Tensor, *,
                             threads: Optional[int] = None,
                             depth: Optional[int] = None) -> torch.Tensor:
    _card(x, y, w, thresholds)
    B, N, F = x.shape
    T = thresholds.shape[2]
    if (y.shape != (B, N) or w.shape != (B, N)
            or thresholds.shape != (B, F, T)):
        raise ValueError(f"stump_scan_batched shapes x{tuple(x.shape)} "
                         f"y{tuple(y.shape)} w{tuple(w.shape)} "
                         f"thr{tuple(thresholds.shape)}")
    x, y, w = _f32("x", x), _f32("y", y), _f32("w", w)
    thr = _f32("thresholds", thresholds)
    err = torch.empty_like(thr)
    if B * F * T == 0:
        return err
    split = None
    if threads is None and depth is None:
        split = scan_batched_split(B, N, F, T, _sms(x.get_device()))
    from repro_torch.kernels.build import load
    with _on_device(x):
        _launch("stump_scan_batched", load().stump_scan_batched_launch,
                x.data_ptr(), y.data_ptr(), w.data_ptr(), thr.data_ptr(),
                err.data_ptr(), B, N, F, T, int(scan_vec(T, thr, err)),
                _knob("threads", threads, 0), _knob("depth", depth, 0),
                *(split or (0, 0, 0, 0)), _stream(x))
    return err


def _vote_args(xsel, thr, pol, alphas):
    B, T, N = xsel.shape
    for name, t in (("thr", thr), ("pol", pol), ("alphas", alphas)):
        if t.shape != (B, T):
            raise ValueError(f"{name} must be {(B, T)}, got {tuple(t.shape)}")
    return (B, T, N, _f32("xsel", xsel), _f32("thr", thr), _f32("pol", pol),
            _f32("alphas", alphas))


def _fp_outputs(B: int, N: int, dev):
    """:func:`stump_vote_fp_batched`'s outputs on ``dev``: the (B,N) f32
    margins and the two (B,N) int32 lanes, one allocation seen three ways
    (one ``torch.empty`` a call, not three)."""
    out, f0, f1 = torch.empty((3, B, N), dtype=torch.int32,
                              device=dev).unbind(0)
    return out.view(F32), f0, f1


def stump_vote_batched(xsel: torch.Tensor, thr: torch.Tensor,
                       pol: torch.Tensor, alphas: torch.Tensor, *,
                       block_t: Optional[int] = None,
                       block_n: Optional[int] = None,
                       backend: Optional[str] = None,
                       policy: Optional[KernelPolicy] = None, **knobs
                       ) -> torch.Tensor:
    """Fused stump margin + weighted vote for packed serving batches:
    xsel (B,T,N), thr/pol/alphas (B,T) -> (B,N) f32.  Zero-alpha padding
    rows contribute nothing whatever thr/pol padding holds.

    On the card the sum has the generic votes' fixed order
    (``csrc/stump_vote.cu``; :func:`ref.stump_vote_in_kernel_order`
    emulates it): a column's result has the same bits whatever else
    shares the batch and whatever the launch, and
    :func:`stump_vote_fp_batched` gives the same.  Knobs: ``tile_c``
    columns a lane (1, 2 or 4), ``deep`` (1: a whole chunk of loads in
    flight, 0: half a chunk) and ``groups``, stages a round (2 only with
    ``tile_c`` < 4 and deep loads)."""
    return dispatch.dispatch("stump_vote_batched", (xsel, thr, pol, alphas),
                             {"block_t": block_t, "block_n": block_n,
                              **knobs}, policy=policy, backend=backend)


def _vote_knobs(tile_c, deep, groups):
    return (_knob("tile_c", tile_c, 0), _knob("deep", deep, -1),
            _knob("groups", groups, 0))


def _stump_vote_batched_cuda(xsel: torch.Tensor, thr: torch.Tensor,
                             pol: torch.Tensor, alphas: torch.Tensor, *,
                             tile_c: Optional[int] = None,
                             deep: Optional[int] = None,
                             groups: Optional[int] = None) -> torch.Tensor:
    _card(xsel, thr, pol, alphas)
    B, T, N, xsel, thr, pol, alphas = _vote_args(xsel, thr, pol, alphas)
    out = torch.empty((B, N), dtype=F32, device=xsel.device)
    if B * N == 0:
        return out
    from repro_torch.kernels.build import load
    with _on_device(xsel):
        _launch("stump_vote_batched", load().stump_vote_launch,
                xsel.data_ptr(), thr.data_ptr(), pol.data_ptr(),
                alphas.data_ptr(), out.data_ptr(), B, T, N,
                *_vote_knobs(tile_c, deep, groups), _stream(xsel))
    return out


def stump_vote_fp_batched(xsel: torch.Tensor, thr: torch.Tensor,
                          pol: torch.Tensor, alphas: torch.Tensor, *,
                          block_t: Optional[int] = None,
                          block_n: Optional[int] = None,
                          backend: Optional[str] = None,
                          policy: Optional[KernelPolicy] = None, **knobs):
    """One-launch serving path: :func:`stump_vote_batched` plus the two
    xor-fold fingerprint lanes per column -> ``(margins (B,N) f32,
    fp0 (B,N), fp1 (B,N))``, the lanes uint32 bits in int32 tensors and
    identical bit for bit on every device and backend.  Knobs as
    :func:`stump_vote_batched`'s."""
    return dispatch.dispatch("stump_vote_fp_batched",
                             (xsel, thr, pol, alphas),
                             {"block_t": block_t, "block_n": block_n,
                              **knobs}, policy=policy, backend=backend)


def _stump_vote_fp_batched_cuda(xsel: torch.Tensor, thr: torch.Tensor,
                                pol: torch.Tensor, alphas: torch.Tensor, *,
                                tile_c: Optional[int] = None,
                                deep: Optional[int] = None,
                                groups: Optional[int] = None):
    _card(xsel, thr, pol, alphas)
    B, T, N, xsel, thr, pol, alphas = _vote_args(xsel, thr, pol, alphas)
    out, f0, f1 = _fp_outputs(B, N, xsel.device)
    if B * N == 0:
        return out, f0, f1
    from repro_torch.kernels.build import load
    with _on_device(xsel):
        _launch("stump_vote_fp_batched", load().stump_vote_fp_launch,
                xsel.data_ptr(), thr.data_ptr(), pol.data_ptr(),
                alphas.data_ptr(), out.data_ptr(), f0.data_ptr(),
                f1.data_ptr(), B, T, N, *_vote_knobs(tile_c, deep, groups),
                _stream(xsel))
    return out, f0, f1


def ensemble_vote_batched(margins: torch.Tensor, alphas: torch.Tensor, *,
                          block_t: Optional[int] = None,
                          block_n: Optional[int] = None,
                          backend: Optional[str] = None,
                          policy: Optional[KernelPolicy] = None, **knobs
                          ) -> torch.Tensor:
    """Per-tenant weighted ensemble margins for packed serving batches:
    margins (B,T,N), alphas (B,T) -> (B,N) f32, sum_t alphas * margins
    (see :func:`ref.ensemble_vote_batched_ref`).

    On the card the sum has one fixed order (``csrc/ensemble_vote.cu``):
    chunks of 32 rows in t order, a fixed tree over each stage's 8 chunks,
    stages added in order.  So a column's result is a fixed function of
    its own alphas and margins: the same bits run to run and whatever else
    shares the batch (B, N, zero padding in T or N).  Zero-alpha padding
    rows over zero margins add exactly nothing; no padding is needed.
    Knob: ``deep`` (1: a whole chunk of loads in flight, one block an SM;
    0: half a chunk at two blocks an SM)."""
    return dispatch.dispatch("ensemble_vote_batched", (margins, alphas),
                             {"block_t": block_t, "block_n": block_n,
                              **knobs}, policy=policy, backend=backend)


def _ensemble_vote_batched_cuda(margins: torch.Tensor, alphas: torch.Tensor,
                                *, deep: Optional[int] = None
                                ) -> torch.Tensor:
    _card(margins, alphas)
    B, T, N = margins.shape
    if alphas.shape != (B, T):
        raise ValueError(f"alphas must be {(B, T)}, got {tuple(alphas.shape)}")
    m, a = _f32("margins", margins), _f32("alphas", alphas)
    out = torch.empty((B, N), dtype=F32, device=m.device)
    if B * N == 0:
        return out
    from repro_torch.kernels.build import load
    with _on_device(m):
        _launch("ensemble_vote_batched", load().ensemble_vote_batched_launch,
                m.data_ptr(), a.data_ptr(), out.data_ptr(), B, T, N,
                _knob("deep", deep, -1), _stream(m))
    return out


def ensemble_vote(margins: torch.Tensor, alphas: torch.Tensor, *,
                  block_t: Optional[int] = None,
                  block_n: Optional[int] = None,
                  backend: Optional[str] = None,
                  policy: Optional[KernelPolicy] = None, **knobs
                  ) -> torch.Tensor:
    """Weighted ensemble margin H = sum_t alphas_t margins_t: margins (T,N),
    alphas (T,) -> (N,) f32 (see :func:`ref.ensemble_vote_ref`).  On the
    card: the batched kernel at B = 1, the same fixed order, so a column
    gives the bits :func:`ensemble_vote_batched` gives it in any batch.
    Knob: ``deep``, as :func:`ensemble_vote_batched`'s."""
    return dispatch.dispatch("ensemble_vote", (margins, alphas),
                             {"block_t": block_t, "block_n": block_n,
                              **knobs}, policy=policy, backend=backend)


def _ensemble_vote_cuda(margins: torch.Tensor, alphas: torch.Tensor, *,
                        deep: Optional[int] = None) -> torch.Tensor:
    _card(margins, alphas)
    T, N = margins.shape
    if alphas.shape != (T,):
        raise ValueError(f"alphas must be {(T,)}, got {tuple(alphas.shape)}")
    m, a = _f32("margins", margins), _f32("alphas", alphas)
    out = torch.empty((N,), dtype=F32, device=m.device)
    if N == 0:
        return out
    from repro_torch.kernels.build import load
    with _on_device(m):
        _launch("ensemble_vote", load().ensemble_vote_launch,
                m.data_ptr(), a.data_ptr(), out.data_ptr(), T, N,
                _knob("deep", deep, -1), _stream(m))
    return out


# csrc/dist_update.cu's constants: blocks of the one cluster (the portable
# cluster size), threads a block at most, float4 a block keeps on chip
DIST_CLUSTER = 8
DIST_THREADS = 1024
DIST_HELD = 14336                    # 224 KB of shared memory
# threads a block on the grid route: one block of 512 an SM streamed
# fastest on the H100 (1024 and 256 slower)
DIST_GRID_THREADS = 512


@functools.lru_cache(maxsize=1024)
def dist_split(N: int, sms: int, cluster: Optional[int] = None,
               threads: Optional[int] = None) -> ref.DistSplit:
    """How :func:`dist_update` spreads N samples on a card of ``sms`` SMs
    (see ``csrc/dist_update.cu`` and :class:`ref.DistSplit`).  Up to
    ``DIST_CLUSTER * DIST_THREADS`` float4 vectors: one cluster of the
    least power of two of blocks, at most 8, that gives a block at most
    256 vectors (at most 1024 with 8), one vector a thread.  Beyond: a
    cooperative grid of one block an SM (so that every block is
    resident), each a tile of ceil(vectors / sms) vectors on up to
    ``DIST_GRID_THREADS`` threads, kept on chip up to ``DIST_HELD``
    vectors a block and computed again past that.

    The launch knobs ask for a route (``cluster`` 1 or 0; the launcher
    refuses the cluster route past its capacity) and for ``threads`` a
    block in place of the above (a power of two, 32..1024)."""
    nv = max(1, -(-N // 4))
    if cluster not in (None, 0, 1):
        raise ValueError(f"dist_update cluster={cluster!r}: 0 or 1")
    use_cluster = (nv <= DIST_CLUSTER * DIST_THREADS if cluster is None
                   else bool(cluster))
    if use_cluster:
        blocks = min(DIST_CLUSTER, 1 << (-(-nv // 256) - 1).bit_length())
    else:
        blocks = sms
    tile = -(-nv // blocks)
    if not use_cluster:
        blocks = -(-nv // tile)
    if threads is None:
        threads = min(DIST_THREADS if use_cluster else DIST_GRID_THREADS,
                      max(32, 1 << (tile - 1).bit_length()))
    return ref.DistSplit(use_cluster, blocks, int(threads), tile,
                         min(tile, DIST_HELD))


def _dist_applies(bucket, layout) -> bool:
    """The cluster route holds at most ``DIST_CLUSTER * DIST_THREADS``
    vectors: past them (on the bucket's N, which no raw N of it exceeds)
    it does not apply."""
    return (layout.get("cluster") != 1
            or bucket[0] <= 4 * DIST_CLUSTER * DIST_THREADS)


def _alpha_arg(alpha, dev: torch.device):
    """``(pointer, value)`` for the launcher: a CUDA tensor on ``dev`` goes
    by pointer (f32, one element); a number or a CPU tensor by value, so a
    call makes no copy to the card and no stream synchronisation."""
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1:
            raise ValueError(f"dist_update alpha must hold one value, got "
                             f"shape {tuple(alpha.shape)}")
        if alpha.device.type == "cuda":
            if alpha.device != dev:
                raise ValueError(f"alpha on {alpha.device}, D on {dev}")
            return _f32("alpha", alpha).data_ptr(), 0.0
    return None, float(alpha)


def _dist_outputs(N: int, split: ref.DistSplit, dev):
    """D' (N,), Z () and, on the grid route, the address of the f64 block
    sums (else None): one allocation, the sums 8-byte aligned after Z and
    passed as an address (a float64 view would cost host time a call)."""
    off = N + 1 + (N + 1) % 2
    parts = 0 if split.cluster else split.blocks
    buf = torch.empty((off + 2 * parts,), dtype=F32, device=dev)
    return buf[:N], buf[N], (buf.data_ptr() + 4 * off) if parts else None


def _dist_update_launch(alpha, D: torch.Tensor, y: torch.Tensor,
                        h: torch.Tensor, split: ref.DistSplit):
    """Launch ``csrc/dist_update.cu`` on checked, contiguous f32 card
    tensors of N >= 1 samples spread as ``split`` says; returns
    ``(D', Z)``.  The launcher refuses a split that does not cover N, and a
    grid that cannot be co-resident (CUDA error 720)."""
    N = D.shape[0]
    a_ptr, a_val = _alpha_arg(alpha, D.device)
    out, Z, parts = _dist_outputs(N, split, D.device)
    from repro_torch.kernels.build import load
    with _on_device(D):
        _launch("dist_update", load().dist_update_launch, a_ptr, a_val,
                D.data_ptr(), y.data_ptr(), h.data_ptr(), out.data_ptr(),
                Z.data_ptr(), parts, N, *split, _stream(D))
    return out, Z


def dist_update(alpha, D: torch.Tensor, y: torch.Tensor, h: torch.Tensor,
                *, block_n: Optional[int] = None,
                backend: Optional[str] = None,
                policy: Optional[KernelPolicy] = None, **knobs):
    """Fused AdaBoost distribution update (paper eq. 4) -> ``(D', Z)``:
    w = D * exp(-alpha * y * h), Z = sum(w) as a 0-d f32 tensor,
    D' = w / (Z + 1e-30) (see :func:`ref.dist_update_ref`).  ``alpha`` is a
    number or a one-element tensor; D, y and h are (N,).

    On the card: one launch, spread as :func:`dist_split` picks for the
    card's SM count; Z is summed in f64 in one fixed order
    (:func:`ref.dist_update_in_kernel_order`) and rounded once, so it is
    the same run to run.  A number or a CPU tensor alpha goes to the
    kernel by value, a CUDA tensor by pointer: the call never waits for
    the card (its bucket comes from D alone).  Knobs: ``cluster`` and
    ``threads`` (:func:`dist_split`); Z's order follows the split, so its
    bits may differ from launch to launch by its rounding."""
    return dispatch.dispatch("dist_update", (alpha, D, y, h),
                             {"block_n": block_n, **knobs}, policy=policy,
                             backend=backend)


def _dist_update_cuda(alpha, D: torch.Tensor, y: torch.Tensor,
                      h: torch.Tensor, *, cluster: Optional[int] = None,
                      threads: Optional[int] = None):
    _card(D, y, h)
    N = D.shape[0]
    if D.dim() != 1 or y.shape != (N,) or h.shape != (N,):
        raise ValueError(f"dist_update shapes D{tuple(D.shape)} "
                         f"y{tuple(y.shape)} h{tuple(h.shape)}")
    D, y, h = _f32("D", D), _f32("y", y), _f32("h", h)
    if N == 0:
        _alpha_arg(alpha, D.device)
        return (torch.empty((0,), dtype=F32, device=D.device),
                torch.zeros((), dtype=F32, device=D.device))
    return _dist_update_launch(alpha, D, y, h, dist_split(
        N, _sms(D.get_device()), cluster, threads))


FLASH_DTYPES = (torch.float32, torch.bfloat16)
FLASH_MAX_D = 128
LOG2E = math.log2(math.e)


def tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where a TMA tensor map can read it in place (last
    stride 1, a 16-byte aligned start, every other stride of an extent
    above 1 a multiple of 16 bytes), else a copy whose rows are padded to
    16 bytes, seen through a view of x's shape.  The padding is never
    read: the map's extent is x's last dimension."""
    e = x.element_size()
    shape, stride = x.shape, x.stride()
    ok = (shape[-1] == 1 or stride[-1] == 1) and x.data_ptr() % 16 == 0
    for n, st in zip(shape[:-1], stride[:-1]):
        ok = ok and (n == 1 or st * e % 16 == 0)
    if ok:
        return x
    d = shape[-1]
    buf = x.new_empty((*shape[:-1], -(-d * e // 16) * 16 // e))
    buf[..., :d] = x
    return buf[..., :d]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    out: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    backend: Optional[str] = None,
                    policy: Optional[KernelPolicy] = None,
                    **knobs) -> torch.Tensor:
    """Softmax attention, q (B,H,T,d), k and v (B,Hkv,T,d) with H a
    multiple of Hkv (query head h reads key and value head h // (H/Hkv))
    -> (B,H,T,d) in q's dtype, f32 softmax at scale 1/sqrt(d); under
    ``causal`` query i sees keys j <= i (see :func:`ref.flash_attention_ref`).

    The card path takes f32 or bf16 inputs of one dtype, any T and any d
    up to 128, each with any strides whose last one is 1: a (B,T,H,d)
    tensor seen through ``.transpose(1, 2)`` is read in place (a layout
    that TMA cannot read, such as rows not a multiple of 16 bytes apart,
    is copied once with padded rows).  ``out``, when given, is a (B,H,T,d)
    tensor of q's dtype with last stride 1 that receives the result and is
    returned: ``out=buf.transpose(1, 2)`` writes a (B,T,H,d) buffer, on
    either backend.  Knob: ``stages``, the K/V ring's depth (bf16 2 in
    place of its own 3; f32 has its own 2 only;
    ``csrc/flash_attention.cu``)."""
    return dispatch.dispatch("flash_attention", (q, k, v),
                             {"causal": causal, "out": out,
                              "block_q": block_q, "block_k": block_k,
                              **knobs}, policy=policy, backend=backend)


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          out: Optional[torch.Tensor] = None,
                          stages: Optional[int] = None) -> torch.Tensor:
    _card(q, k, v, *(() if out is None else (out,)))
    shape, kv_shape = q.shape, k.shape
    if len(shape) != 4 or len(kv_shape) != 4 or v.shape != kv_shape \
            or kv_shape[0] != shape[0] or kv_shape[2:] != shape[2:] \
            or kv_shape[1] < 1 or shape[1] % kv_shape[1]:
        raise ValueError(f"flash_attention shapes q{tuple(shape)} "
                         f"k{tuple(kv_shape)} v{tuple(v.shape)}: need q "
                         f"(B,H,T,d) and k, v (B,Hkv,T,d), Hkv dividing H")
    dtype = q.dtype
    if dtype not in FLASH_DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"flash_attention takes one of {FLASH_DTYPES}, got "
                        f"{dtype}, {k.dtype}, {v.dtype}")
    B, H, T, d = shape
    if not 1 <= d <= FLASH_MAX_D:
        raise ValueError(f"flash_attention head dim {d} not in "
                         f"1..{FLASH_MAX_D}")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=q.device)
    elif out.shape != shape or out.dtype != dtype \
            or (d > 1 and out.stride(-1) != 1):
        raise ValueError(f"flash_attention out {tuple(out.shape)} "
                         f"{out.dtype} stride {out.stride()}: need "
                         f"{tuple(shape)} {dtype}, last stride 1")
    if B * H * T == 0:
        return out
    q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
    strides = (ctypes.c_longlong * 12)(*(q.stride()[:3] + k.stride()[:3]
                                         + v.stride()[:3] + out.stride()[:3]))
    from repro_torch.kernels.build import load
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, H, kv_shape[1], T, d, int(causal),
            int(dtype == torch.bfloat16), LOG2E / math.sqrt(d),
            _knob("stages", stages, 0), _stream(q))
    with _on_device(q):
        _launch("flash_attention", load().flash_attention_launch, *args)
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """:func:`flash_attention` as a PyTorch op, (B,H,T,d) -> (B,H,T,d):
    the same dispatch (the kernel on the card, the plain version on the
    CPU), its result written into a (B,T,H,d) buffer and returned as the
    (B,H,T,d) view of it, so ``.transpose(1, 2)`` of the result is a
    contiguous (B,T,H,d) tensor.  As an op it has a fake version (shapes
    and dtype, for a fake tensor) and a FLOP formula
    (:func:`flash_flops`)."""
    B, H, T, d = q.shape
    out = torch.empty((B, T, H, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    return flash_attention(q, k, v, causal=causal, out=out)


@_flash_op.register_fake
def _(q, k, v, causal):
    B, H, T, d = q.shape
    return q.new_empty((B, T, H, d)).transpose(1, 2)


FLASH_OP = torch.ops.repro_torch.flash_attention


def flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
                **kwargs) -> int:
    """FLOPs of one flash call: the two products, 2 * d multiply-adds a
    (query, key) pair each, over the pairs it computes: T * (T + 1) / 2
    a head under ``causal`` (the mask's half), T * T in full mode."""
    B, H, T, d = q_shape
    pairs = T * (T + 1) // 2 if causal else T * T
    return 4 * B * H * d * pairs


from torch.utils.flop_counter import register_flop_formula  # noqa: E402

register_flop_formula(FLASH_OP)(flash_flops)


dispatch.CUDA_LAYOUT_APPLIES["dist_update"] = _dist_applies
dispatch.CUDA_IMPLS.update({
    "stump_scan": _stump_scan_cuda,
    "stump_scan_batched": _stump_scan_batched_cuda,
    "ensemble_vote": _ensemble_vote_cuda,
    "ensemble_vote_batched": _ensemble_vote_batched_cuda,
    "stump_vote_batched": _stump_vote_batched_cuda,
    "stump_vote_fp_batched": _stump_vote_fp_batched_cuda,
    "flash_attention": _flash_attention_cuda,
    "dist_update": _dist_update_cuda,
})
