"""The readers that ``metrics/<name>.py`` files name: each takes the run's
context (``harness.run_cell``'s ``ctx``) and returns the metric, or None
where the run holds nothing to read it from."""

from __future__ import annotations

from benchmark import bounds


def setup_s(ctx):
    return ctx["setup_s"]


def reads_per_s(ctx):
    """Reads of the batches completed in the window over the window: from
    the warm batch's lines to the last completed batch's."""
    return ctx["reads_done"] / ctx["window_s"] if ctx["window_s"] else None


def device_idle(ctx):
    """1 - the device's busy share of the traced window."""
    if not ctx.get("trace_window_s"):
        return None
    return 1.0 - ctx["busy_s"] / ctx["trace_window_s"]


def _warm(ctx, stage):
    """Host ms per read of ``stage`` over the batches after the first
    (``run()``'s ``stage_seconds_warm``)."""
    st = ctx["stats"]
    warm = st.get("stage_seconds_warm", {})
    n = st.get("counters", {}).get("num_reads", 0) - ctx["first_reads"]
    if stage not in warm or n <= 0:
        return None
    return warm[stage] / n * 1e3


def extend_decode_ms(ctx):
    return _warm(ctx, "extend_decode")


def filter_ms(ctx):
    return _warm(ctx, "filter")


def seed_ms(ctx):
    return _warm(ctx, "seed")


def spec_hit_rate(ctx):
    c = ctx["stats"].get("counters", {})
    h, m = c.get("num_spec_hits", 0), c.get("num_spec_misses", 0)
    return h / (h + m) if h + m else None


def index_build_s(ctx):
    return ctx["stats"].get("index_seconds")


def gact_dp_roofline(ctx):
    """The DP's needed operations at the card's peak, as a share (%) of
    the ``gact_dp`` kernel's device time over the align phase."""
    t = sum(s for n, s in ctx.get("kernel_s", {}).items()
            if "gact_dp_kernel" in n)
    c = ctx["stats"].get("counters")
    if not t or not c:
        return None
    return bounds.needed_dp_ops(c) / bounds.PEAK_INT32_OPS_S / t * 100

