from benchmark.overlap import print_format_ms as read  # noqa: F401
