from benchmark.overlap import dropped_column_share as read  # noqa: F401
