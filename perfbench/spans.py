"""The program's own spans from the traced federations, for the readers of
span metrics: what ``repro_torch.obs`` recorded while the harness's
profiler ran (its profiled tracer), device spans resolved.  A program
that records no spans there gives an empty list."""
from typing import Dict, List


def traced_spans() -> List[Dict]:
    from repro_torch import obs
    profiled = getattr(obs, "profiled_tracer", None)
    tracer = profiled() if profiled is not None else None
    if tracer is None:
        return []
    obs.resolve()
    return tracer.finished()


def children(spans: List[Dict], name: str) -> Dict[int, List[Dict]]:
    """The ``name`` spans grouped by their parent's span id."""
    out: Dict[int, List[Dict]] = {}
    for s in spans:
        if s["name"] == name:
            out.setdefault(s["parent"], []).append(s)
    return out


def host_ms(span: Dict) -> float:
    """The span's host ms less what recording its descendants took inside
    it (``rec_s``; its own recording lies outside ``t0``..``t1``)."""
    return (span["t1"] - span["t0"] - span.get("rec_s", 0.0)) * 1e3
