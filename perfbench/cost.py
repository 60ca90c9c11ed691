"""Operations and bytes from shapes, and the NVIDIA H100's peaks.

A least time is the larger of the bytes over the HBM bandwidth and the
operations over their peak rates (NVIDIA's data sheet for the H100 SXM part,
dense rates, at its 700 W limit).  Each input byte is counted read once and
each output byte written once.  The per-kernel counts are those the repo's
smoke driver used for its bound column; the round's counts are the
algorithm's least work, whatever the program materialises on the way.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores
F64_OPS_PER_S = 34e12           # f64 outside the tensor cores


def least_s(nbytes: float, ops_f32: float = 0.0,
            ops_f64: float = 0.0) -> float:
    """Seconds the chip needs at least for this many bytes and operations."""
    return max(nbytes / HBM_BYTES_PER_S,
               ops_f32 / F32_OPS_PER_S + ops_f64 / F64_OPS_PER_S)


def stump_scan_batched(B: int, N: int, F: int, T: int, misses: int):
    """(bytes, f32 operations, f64 operations) of one batched stump scan:
    x (B,N,F), y and w (B,N) and the (B,F,T) grid read, the (B,F,T) errors
    written; two compares a cell and one f64 add a miss of these inputs."""
    nbytes = 4 * (B * N * F + 2 * B * N + 2 * B * F * T)
    return nbytes, 2.0 * B * N * F * T, float(misses)


def stump_vote_batched(B: int, T: int, N: int):
    """(bytes, f32 operations) of one stump vote: xsel (B,T,N) and the three
    (B,T) rows read, the (B,N) margins written; a subtract, an add, two
    compares and two multiplies a cell."""
    return 4 * B * T * N + 12 * B * T + 4 * B * N, 6.0 * B * T * N


def local_round(K: int, n: int, F: int, T: int, misses: int) -> float:
    """Least seconds of one boosting round on every client: the shards, the
    labels and the distributions and the shared (F,T) grid read, the
    distributions and the (K,4) picks written; the scan's compares and f64
    adds."""
    nbytes = 4 * (K * n * F + 3 * K * n + F * T + 4 * K)
    return least_s(nbytes, 2.0 * K * n * F * T, float(misses))


def sync(K: int, n: int, nv: int, F: int, m: int) -> float:
    """Least seconds of one sync over ``m`` buffered stumps: the shards,
    validation slices, labels, distributions, margins and the stumps read,
    the distributions, margins and the folded stumps written; a stump's
    margin and weighted vote (6 operations) on every client row for the
    foreign update, and on every validation row for the miss counts and
    again for the margins."""
    nbytes = 4 * (K * n * F + K * nv * F + 3 * K * n + 3 * K * nv
                  + 2 * 5 * m)
    return least_s(nbytes, 6.0 * K * m * (n + 2 * nv))
