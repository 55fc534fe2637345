"""Per-step readings of the program's own spans
(``bert4rec_tpu_torch.utils.profiling``): a window's log of ``Span``s, each
with its wall-clock start and end, name, enclosing span and thread."""

STEP = "trainer.step"


def steps(log: list) -> list:
    return [s for s in log if s.name == STEP]


def _ns(span) -> int:
    return span.end_ns - span.start_ns


def _union(intervals: list) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def _inside(span, name: str) -> bool:
    parent = span.parent
    while parent is not None:
        if parent.name == name:
            return True
        parent = parent.parent
    return False


def _children(log: list) -> dict:
    out = {}
    for c in log:
        if c.parent is not None:
            out.setdefault(c.parent, []).append((c.start_ns, c.end_ns))
    return out


def _self_ns(span, children: dict) -> int:
    """The span's duration less the part its children cover."""
    return _ns(span) - _union(children.get(span, []))


def per_step_ms(log: list, names: tuple, self_time: bool = False,
                within: str = STEP) -> "float | None":
    """Mean ms per ``trainer.step`` of the spans named ``names`` (their
    self time with ``self_time``). ``within`` is the span they must lie
    in; None takes the main thread's top-level spans (those of the
    steps' thread without a parent)."""
    done = steps(log)
    if not done:
        return None
    main = done[0].thread
    children = _children(log) if self_time else {}
    total = 0
    for s in log:
        if s.name not in names:
            continue
        if within is None:
            if s.parent is not None or s.thread != main:
                continue
        elif not _inside(s, within):
            continue
        total += _self_ns(s, children) if self_time else _ns(s)
    return total / len(done) / 1e6


def coverage(log: list) -> "float | None":
    """The share of the steps' time their child spans cover."""
    done = steps(log)
    if not done:
        return None
    children = _children(log)
    covered = sum(_ns(s) - _self_ns(s, children) for s in done)
    return covered / sum(_ns(s) for s in done)


def uncovered_ms(log: list) -> "dict | None":
    """Mean ms per step of the step's time no child covers: before its
    first child, between children and after its last."""
    done = steps(log)
    if not done:
        return None
    children = _children(log)
    out = {"before": 0, "between": 0, "after": 0}
    for s in done:
        kids = sorted(children.get(s, []))
        if not kids:
            out["before"] += _ns(s)
            continue
        out["before"] += kids[0][0] - s.start_ns
        out["after"] += s.end_ns - max(e for _, e in kids)
        out["between"] += _self_ns(s, children) - (kids[0][0] - s.start_ns) \
            - (s.end_ns - max(e for _, e in kids))
    return {k: v / len(done) / 1e6 for k, v in out.items()}
