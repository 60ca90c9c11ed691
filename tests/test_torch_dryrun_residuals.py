"""The dry run's per-device FLOPs at full size, op by op, where they are
not the JAX package's (ROADMAP C8): every such combination of the sweeps
is the port's count plus a named residual, each an op the JAX package's
compiled step repeats or counts otherwise, read from both packages' dot
rows (``tools/dryrun_dot_breakdown.py``: the reference compiled in a
process of its own on 512 placeholder devices, the port traced on the
fake production mesh).

The residuals, as the port's rows give them:

* matrix-vector: a product whose first operand has one row (a one-row
  decode's projections), which XLA's CPU compiler rewrites as a multiply
  and a reduction where the matrix is small, so the reference counts no
  ``dot`` for it (every such product here up to gemma2's 288 x 16,000
  logits matrix, but not llama4's 5,120 x 12,632 at 2x16x16: matrices
  under ``VEC_MATRIX`` elements);
* whole heads: where the model axis does not divide the heads, XLA keeps
  a whole head's Q·Kᵀ (llama4's prefill: both products) on 2 devices of
  the axis, where the port splits the head dim (decode) or the queries
  (prefill) over all of them;
* the idle batch axes: a one-row decode's P·V over the whole cache on
  every device of the data (and pod) axes, where the port splits its q
  heads over them;
* Jamba's gate/up products at 2x16x16 on the whole d_model, the FSDP
  weight gathered, where the port contracts its shard;
* whisper's encoder queries padded from 1,500 to 1,504 rows in the port
  (the axis divides the rows), work the reference does not do.
"""
import importlib.util
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-9
VEC_MATRIX = 1 << 24


def _tool():
    spec = importlib.util.spec_from_file_location(
        "dryrun_dot_breakdown", ROOT / "tools" / "dryrun_dot_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(port, frames):
    return [r for who, g in port["groups"].items() if who in frames
            for r in g["rows"]]


def _qk(row):
    """A product contracting fewer elements than its result row holds:
    an attention's Q·Kᵀ (the head dim against the keys), or a gate/up
    product (d_model against d_ff)."""
    lhs, rhs = row[1]
    return lhs[-1] < rhs[-1]


def _sum(rows, keep=lambda r: True):
    return sum(r[3] for r in rows if keep(r))


ATTN = ("models/attention.py:_attend_row", "models/attention.py:_sdpa_chunked")


def _vec(port):
    return sum(r[3] for g in port["groups"].values() for r in g["rows"]
               if r[0] != "flash_attention" and math.prod(r[1][0][:-1]) == 1
               and math.prod(r[1][1]) < VEC_MATRIX)


def _whole_head_qk(port):
    return _sum(_rows(port, ATTN), _qk)


def _whole_head_both(port):
    return _sum(_rows(port, ATTN))


def _idle_pv(n):
    return lambda port: (n - 1) * _sum(
        _rows(port, ("models/attention.py:_attend_row",)),
        lambda r: not _qk(r))


def _jamba_2pod(port):
    gate_up = _sum(_rows(port, ("models/moe.py:_swiglu",)), _qk)
    return _idle_pv(32)(port) + 15 * gate_up


def _whisper_prefill(port):
    rows = _rows(port, ATTN)
    enc = [r for r in rows if 1500 in (r[1][0][-1], r[1][1][-1])
           and r[1][0][-2] != 512]
    dec_qk = _sum([r for r in rows if r not in enc], _qk)
    return dec_qk - _sum(enc) * 4 / 1504


# cell -> what the JAX package counts beyond (port - matrix-vector rows)
CELLS = {
    "gemma2-27b/long_500k/pod16x16": lambda p: 0.0,
    "gemma2-27b/long_500k/pod2x16x16": lambda p: 0.0,
    "mamba2-1.3b/long_500k/pod16x16": lambda p: 0.0,
    "mamba2-1.3b/long_500k/pod2x16x16": lambda p: 0.0,
    "jamba-1.5-large-398b/long_500k/pod16x16": _idle_pv(16),
    "jamba-1.5-large-398b/long_500k/pod2x16x16": _jamba_2pod,
    "whisper-base/decode_32k/pod16x16": _whole_head_qk,
    "whisper-base/decode_32k/pod2x16x16": _whole_head_qk,
    "llama4-scout-17b-a16e/decode_32k/pod16x16": _whole_head_qk,
    "llama4-scout-17b-a16e/decode_32k/pod2x16x16": _whole_head_qk,
    "llama4-scout-17b-a16e/prefill_32k/pod16x16": _whole_head_both,
    "llama4-scout-17b-a16e/prefill_32k/pod2x16x16": _whole_head_both,
    "whisper-base/prefill_32k/pod16x16": _whisper_prefill,
    "whisper-base/prefill_32k/pod2x16x16": _whisper_prefill,
}


@pytest.fixture(scope="module")
def breakdowns():
    tool = _tool()
    cells = [c.split("/") for c in CELLS]
    with ThreadPoolExecutor(4) as pool:
        refs = list(pool.map(lambda c: tool.reference(
            c[0], c[1], c[2] == "pod2x16x16"), cells))
    return {cell: {"reference": ref, "port": tool.port(
        a, s, m == "pod2x16x16")} for cell, ref, (a, s, m) in
        zip(CELLS, refs, cells)}


@pytest.mark.parametrize("cell", list(CELLS))
def test_full_size_gap_is_its_named_residual(cell, breakdowns):
    """The JAX package's per-device FLOPs equal the port's, less its
    matrix-vector rows, plus the cell's named residual, within REL."""
    b = breakdowns[cell]
    port, ref = b["port"], b["reference"]
    vec = _vec(port)
    extra = CELLS[cell](port)
    got = port["flops_corrected"] - vec + extra
    want = ref["flops_corrected"]
    print(f"{cell}: port {port['flops_corrected']:.6e} - matrix-vector "
          f"{vec:.6e} + residual {extra:.6e} = {got:.6e}; JAX {want:.6e}")
    assert abs(got - want) <= REL * want, (cell, got, want)
