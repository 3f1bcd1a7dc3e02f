"""Readers of what overlap mode adds to a traced run: the MHAP printer's
``print_format`` spans and its counters of the alignments' fates
(``pipeline.printer.mhap_lines``).  Each returns None where the run
recorded no such span or counter."""

from __future__ import annotations

from benchmark import spans


def print_format_ms(ctx):
    """The ``print_format`` spans of the batches after the first, less
    their thread's waits inside them, ms a read."""
    table = ctx.get("stats", {}).get("spans")
    if table is None or not any(s[0] == "print_format"
                                for s in table["spans"]):
        return None
    return spans._per_read(ctx, spans.self_ns(table["spans"], "print_format"))


def dropped_column_share(ctx):
    """The share of the extended alignments' columns that the MHAP
    printer drops: not selected, a read against itself, or shorter than
    ``min_overlap``."""
    c = ctx.get("stats", {}).get("counters", {})
    if "mhap_columns_dropped" not in c:
        return None
    total = c["mhap_columns_printed"] + c["mhap_columns_dropped"]
    return c["mhap_columns_dropped"] / total if total else None
